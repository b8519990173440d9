"""Collection orchestration: validation, insert pipeline, search modes,
snapshot/restore.

This is the accelerator equivalent of ``Vettore.Collection``
(/root/reference/lib/vettore/collection.ex): the canonical record store lives
on host, acceleration state (flat/HNSW index, adaptive scan caches) lives on
device and is always rebuildable from the store. Search modes:

* ``search``        — index scan (flat exact or HNSW ANN)
* ``funnel_search`` — Matryoshka prefix staging + exact rerank, fused on device
* ``quantized_search`` — sign-bit Hamming candidates + exact rerank, fused
* ``multi_vector_search`` — ColBERT MaxSim late interaction
* ``hybrid_search`` — candidate generator union + exact/MaxSim rerank

Option validation is strict (unknown/duplicate options rejected,
collection.ex:1116-1157); score/distance semantics follow
``Distance.result_values`` exactly.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable

import jax
import jax.numpy as jnp
import numpy as np

from . import errors as E
from .embedding import Embedding, Result
from .index.base import Index, valid_index
from .index.flat import FlatIndex
from .metrics import (
    F32_MAX,
    MAX_USIZE,
    METRICS,
    default_normalize,
    normalize_metric,
    result_values,
)
from .ops import maxsim as maxsim_ops
from .ops import pipeline as pipe
from .ops import scan_host
from .ops.distance import NORMALIZATIONS, normalize_rows, validate_vector
from .ops.transport import put_f32_matrix
from .ops.packing import (
    pack_signs_u32,
    pack_signs_u64_rows,
    words_for,
)
from .observability import StatsRegistry, observed
from .store.base import Store, valid_store
from .store.memory import MemoryStore

SNAPSHOT_VERSION = 1
_SCORE_MODES = ("raw", "similarity")
_SNAPSHOT_OVERRIDE_KEYS = ("name", "index", "index_options", "score", "store")


def _validate_limit(limit):
    if not isinstance(limit, int) or isinstance(limit, bool) or not 0 < limit <= MAX_USIZE:
        raise E.InvalidLimit(f"invalid limit: {limit!r}")


def _validate_candidates(candidates, limit):
    if (
        not isinstance(candidates, int)
        or isinstance(candidates, bool)
        or candidates < limit
        or candidates <= 0
        or candidates > MAX_USIZE
    ):
        raise E.InvalidCandidates(f"invalid candidates: {candidates!r}")


def _reject_extra(extra: dict):
    if extra:
        raise E.UnsupportedOption(next(iter(extra)))


def _pow2_at_least(n: int, floor: int = 8) -> int:
    return max(floor, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


_ROW_TILE = 1024
_BIG32 = 2**31 - 1


def _mv_chunk(cap: int, b: int, qt: int, t: int) -> int:
    """Doc-chunk size for the streaming MaxSim scan: bounds the
    [B, chunk, Qt, T] similarity block to ~512 MB f32 (the only large
    intermediate; the token block itself stays resident)."""
    budget = 512 * 1024 * 1024 // 4
    per_row = max(1, b * qt * t)
    chunk = max(budget // per_row, 1)
    chunk = max(1024, 1 << int(math.floor(math.log2(chunk))))
    return min(cap, chunk)


def _cap_at_least(n: int, floor: int = 8) -> int:
    """Scan-cache capacity: pow2 below one row tile, then the next tile
    multiple — <0.1% padded rows instead of up to 100% (the reference scans
    exactly n records, collection.ex:699-713)."""
    if n <= _ROW_TILE:
        return _pow2_at_least(n, floor)
    return -(-n // _ROW_TILE) * _ROW_TILE


def _has_tokens(vs) -> bool:
    """True when a record carries a non-empty multi-vector token set —
    either a list/tuple of rows (put/put_many) or a [t, d] ndarray
    (put_tokens). Plain truthiness would raise on a multi-row ndarray."""
    return vs is not None and len(vs) > 0


class _VectorCache:
    """Device-resident mirror of all stored primary vectors for adaptive
    scans (funnel/quantized/hybrid/exact-rerank). Rebuilt from the canonical
    store whenever the collection mutates — the same canonical-vs-acceleration
    split the reference keeps between ETS and native resources.

    Records are held in LEXICOGRAPHIC id order, so slot order == id order:
    stable top-k resolves equal-rank ties to the smallest id with no
    per-query [n]-gather through a lex permutation (that gather dominated
    the adaptive pipelines at 1M rows)."""

    def __init__(self, records, dimensions, mesh=None):
        self.n = len(records)
        ids = []
        seen = set()
        for r in records:
            if not isinstance(r, Embedding) or not isinstance(r.id, str) or r.id == "":
                raise E.InvalidEmbedding("invalid embedding in store")
            if r.id in seen:
                raise E.DuplicateId(f"duplicate id: {r.id!r}")
            seen.add(r.id)
            ids.append(r.id)
        order = np.argsort(np.array(ids, dtype=str), kind="stable") if ids else []
        self.records = [records[i] for i in order]
        self.ids = [ids[i] for i in order]
        self.slot_of = {id: i for i, id in enumerate(self.ids)}
        self.by_id = {id: r for id, r in zip(self.ids, self.records)}
        self.mesh = mesh
        self.cap = _cap_at_least(self.n)
        if mesh is not None:
            # row-sharded blocks need cap % shards == 0 (equal shard rows)
            shards = mesh.shape["shard"]
            self.cap = -(-self.cap // shards) * shards
        self.dimensions = dimensions
        self._x = None
        self._valid = None
        self._host_mat = None
        self._bits = None
        self._signs = None
        self._mv = None
        self._ids_np = None
        self._index_tables = {}

    def _stack_vectors(self) -> np.ndarray:
        """One [n, d] f32 matrix of all primary vectors, validated in bulk —
        the rebuild must be O(n) numpy work, not O(n) Python (a fresh cache is
        paid on the first adaptive scan after any mutation)."""
        if self._host_mat is not None:
            return self._host_mat
        rows = [r.vector for r in self.records]
        if any(v is None for v in rows):
            raise E.InvalidVector("embedding has no vector")
        d = self.dimensions
        if all(isinstance(v, np.ndarray) and v.shape == (d,) for v in rows):
            # the insert pipeline stores vectors as numpy rows; concatenate
            # is ~10x faster than asarray on a list of 1M array objects
            block = np.concatenate(rows, dtype=np.float32).reshape(self.n, d)
        else:
            try:
                block = np.asarray(rows, dtype=np.float32)
            except (TypeError, ValueError):
                block = None
        if block is None or block.ndim != 2 or block.shape[1] != self.dimensions:
            # ragged / wrong-width / non-numeric: re-walk for the precise error
            for v in rows:
                if len(v) != self.dimensions:
                    raise E.DimensionMismatch("dimension mismatch")
                np.asarray(v, dtype=np.float32)
            raise E.InvalidVector("vector must be numeric")
        with np.errstate(invalid="ignore"):
            if not np.isfinite(block).all():
                raise E.InvalidVector("vector contains a non-finite value")
        self._host_mat = block
        return block

    def _put(self, arr):
        """Places a host block on device; row-sharded over the mesh's
        ``shard`` axis when the collection has one (SURVEY §5.8 — the
        adaptive modes run where the memory is)."""
        if self.mesh is None:
            return jnp.asarray(arr)
        from jax.sharding import NamedSharding, PartitionSpec as P

        spec = P(*(("shard",) + (None,) * (arr.ndim - 1)))
        return jax.device_put(arr, NamedSharding(self.mesh, spec))

    def valid_mask(self):
        """Device [cap] bool marking live slots — the cache is lex-packed so
        this is just ``slot < n`` (no need to materialize the primary block
        for multi-vector-only searches)."""
        if self._x is not None:
            return self._x[1]
        if self._valid is None:
            self._valid = self._put(np.arange(self.cap) < self.n)
        return self._valid

    def vectors(self):
        if self._x is not None:
            return self._x
        mat = np.zeros((self.cap, self.dimensions), dtype=np.float32)
        if self.n:
            mat[: self.n] = self._stack_vectors()
        valid = np.zeros(self.cap, dtype=bool)
        valid[: self.n] = True
        if self.mesh is not None:
            self._x = (self._put(mat), self._put(valid))
            return self._x
        from .ops.transport import put_f32_matrix

        # records are lex-sorted, so slot order IS id order; bf16-exact
        # blocks ship as 16-bit halves (bit-identical on device)
        self._x = (put_f32_matrix(mat), jnp.asarray(valid))
        return self._x

    def bits(self):
        """Packed sign bits per record: stored ``binary_vector`` words when
        present (validated), else packed from the primary vector
        (collection.ex:730-740)."""
        if self._bits is not None:
            return self._bits
        expected_words = words_for(self.dimensions)
        width = 2 * expected_words
        out = np.zeros((self.cap, width), dtype=np.uint32)
        with_bv = [i for i, r in enumerate(self.records) if r.binary_vector is not None]
        without = [i for i, r in enumerate(self.records) if r.binary_vector is None]
        if with_bv:
            for i in with_bv:
                bv = self.records[i].binary_vector
                # signed numpy arrays would WRAP under a uint64 cast (only
                # Python ints raise OverflowError on negatives)
                if isinstance(bv, np.ndarray) and bv.dtype.kind in "if" and (bv < 0).any():
                    raise E.InvalidBinaryVector("invalid binary vector")
            try:
                words = np.asarray(
                    [self.records[i].binary_vector for i in with_bv], dtype=np.uint64
                )
            except (TypeError, ValueError, OverflowError) as exc:
                raise E.InvalidBinaryVector("invalid binary vector") from exc
            if words.ndim != 2 or words.shape[1] != expected_words:
                raise E.InvalidBinaryVector("invalid binary vector")
            rem = self.dimensions % 64
            if rem:
                words[:, -1] &= np.uint64((1 << rem) - 1)
            block = np.empty((len(with_bv), width), dtype=np.uint32)
            block[:, 0::2] = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            block[:, 1::2] = (words >> np.uint64(32)).astype(np.uint32)
            out[with_bv] = block
        if without:
            for i in without:
                v = self.records[i].vector
                if v is None or len(v) != self.dimensions:
                    raise E.DimensionMismatch("dimension mismatch")
            sub = np.asarray(
                [self.records[i].vector for i in without], dtype=np.float64
            )
            if not np.isfinite(sub).all():
                raise E.InvalidVector("vector contains a non-finite value")
            out[without] = pack_signs_u32(sub)
        self._bits = self._put(out)
        return self._bits

    def multi_vectors(self):
        """Padded ``[cap, T, d]`` doc-token block: ``vectors`` when non-empty,
        else the primary vector (collection.ex:773-777)."""
        if self._mv is not None:
            return self._mv
        if all(not _has_tokens(r.vectors) for r in self.records):
            # plain single-vector corpus: the token block IS the primary
            # matrix, one stack instead of a per-record walk
            tokens = np.zeros((self.cap, 1, self.dimensions), dtype=np.float32)
            counts = np.zeros(self.cap, dtype=np.int32)
            has = np.array([r.vector is not None for r in self.records], dtype=bool)
            if has.all() and self.n:
                tokens[: self.n, 0] = self._stack_vectors()
                counts[: self.n] = 1
            else:
                for i, r in enumerate(self.records):
                    if r.vector is None:
                        continue
                    if len(r.vector) != self.dimensions:
                        raise E.DimensionMismatch("dimension mismatch")
                    row = np.asarray(r.vector, dtype=np.float32)
                    if not np.isfinite(row).all():
                        raise E.InvalidMultiVector("invalid multi vector")
                    tokens[i, 0] = row
                    counts[i] = 1
            self._mv = (self._put_tokens(tokens), self._put(counts))
            return self._mv
        first = self.records[0].vectors if self.records else None
        if (
            isinstance(first, np.ndarray)
            and first.ndim == 2
            and first.shape[1] == self.dimensions
            and all(
                isinstance(r.vectors, np.ndarray) and r.vectors.shape == first.shape
                for r in self.records
            )
        ):
            # bulk-ingested corpus (put_tokens): one [n*t, d] concatenate
            # instead of a million-record Python walk
            t = first.shape[0]
            t_max = _pow2_at_least(t, 1)
            tokens = np.zeros((self.cap, t_max, self.dimensions), dtype=np.float32)
            block = np.concatenate(
                [r.vectors for r in self.records], dtype=np.float32
            ).reshape(self.n, t, self.dimensions)
            if not np.isfinite(block).all():
                raise E.InvalidMultiVector("invalid multi vector")
            tokens[: self.n, :t] = block
            counts = np.zeros(self.cap, dtype=np.int32)
            counts[: self.n] = t
            self._mv = (self._put_tokens(tokens), self._put(counts))
            return self._mv
        docs = []
        for r in self.records:
            vs = r.vectors if _has_tokens(r.vectors) else (
                [r.vector] if r.vector is not None else [])
            # len(), not truthiness: vs may be a [t, d] ndarray (put_tokens
            # records mixed with list-vectors records in one collection)
            if len(vs) == 0:
                docs.append(np.zeros((0, self.dimensions), dtype=np.float32))
                continue
            try:
                rows = np.asarray(vs, dtype=np.float32)
            except (TypeError, ValueError) as exc:
                raise E.InvalidMultiVector("invalid multi vector") from exc
            if rows.ndim != 2 or rows.shape[1] != self.dimensions:
                raise E.DimensionMismatch("dimension mismatch")
            if not np.isfinite(rows).all():
                raise E.InvalidMultiVector("invalid multi vector")
            docs.append(rows)
        t_max = _pow2_at_least(max((len(d) for d in docs), default=1), 1)
        tokens = np.zeros((self.cap, t_max, self.dimensions), dtype=np.float32)
        counts = np.zeros(self.cap, dtype=np.int32)
        for i, rows in enumerate(docs):
            counts[i] = len(rows)
            tokens[i, : len(rows)] = rows
        self._mv = (self._put_tokens(tokens), self._put(counts))
        return self._mv

    def _put_tokens(self, tokens: np.ndarray):
        """Places a token block, bfloat16-resident when lossless (half the
        HBM — the difference between a 1M x 32 x 128 corpus fitting on one
        chip or not); row-sharded on a mesh."""
        if self.mesh is None:
            from .ops.transport import put_token_block

            return put_token_block(tokens)
        from .ops.transport import is_bf16_exact

        if tokens.size and is_bf16_exact(tokens):
            import ml_dtypes

            tokens = tokens.astype(ml_dtypes.bfloat16)
        return self._put(tokens)

    def signs(self):
        """Device-resident ±1 int8 sign block [cap, d] for matmul Hamming —
        expanded on device from the packed words (no extra host transfer)."""
        if self._signs is None:
            from .ops.pipeline import signs_from_bits

            signs = signs_from_bits(self.bits(), d=self.dimensions)
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                signs = jax.device_put(
                    signs, NamedSharding(self.mesh, P("shard", None)))
            self._signs = signs
        return self._signs

    def fde(self, cfg):
        """Device MUVERA document-FDE block for candidate generation:
        ``(fde [cap, W] bf16, bias [cap] f32)`` — encoded on device from the
        resident token block (ops/muvera_fde), built once per cache
        generation per config. bf16 residency keeps a 1M x 2048 FDE block at
        ~4 GB next to the 7.6 GB token block."""
        from .ops import muvera_fde

        key = ("fde", muvera_fde.config_key(cfg))
        if key not in self._index_tables:
            tokens, counts = self.multi_vectors()
            fde16 = muvera_fde.encode_documents_device(
                tokens, counts, cfg, out_dtype=jnp.bfloat16)
            bias = jnp.where(self.valid_mask(), 0.0, jnp.inf).astype(jnp.float32)
            self._index_tables[key] = (fde16, bias)
        return self._index_tables[key]

    def index_slot_table(self, index):
        """Device int32 table mapping an index's internal slots to cache
        (lex) slots, ``2**31 - 1`` where an index slot's id is absent from
        the cache — lets hybrid generators stay on device end to end.
        Returns None for custom indexes without a device slot vocabulary."""
        key = id(index)
        if key in self._index_tables:
            return self._index_tables[key]
        index_ids = None
        vocab = getattr(index, "hybrid_id_vocab", None)
        if isinstance(index, FlatIndex):
            index_ids = index._ids
        elif callable(vocab):
            # IVF and other indexes with a dynamic device-slot vocabulary;
            # the table must NOT cache across mutations — keyed per version
            index_ids = vocab()
        else:
            # HNSW: the device graph's id list (callers touch the device
            # search path first, which refreshes _device)
            graph = getattr(index, "_bulk", None) or getattr(index, "_device", None)
            if graph is not None and hasattr(graph, "ids"):
                index_ids = graph.ids
        if index_ids is None:
            self._index_tables[key] = None
            return None
        if self._ids_np is None:
            self._ids_np = np.asarray(self.ids, dtype=str)
        src = np.asarray([i if isinstance(i, str) else "" for i in index_ids], dtype=str)
        if self.n:
            pos = np.searchsorted(self._ids_np, src)
            posc = np.clip(pos, 0, self.n - 1)
            match = self._ids_np[posc] == src
            table = np.where(match, posc, np.int32(2**31 - 1)).astype(np.int32)
        else:
            table = np.full(len(src), 2**31 - 1, dtype=np.int32)
        dev = jnp.asarray(table)
        self._index_tables[key] = dev
        return dev


def _mv_pipeline(tokens, counts, valid, queries, *, metric, limit):
    totals, pair_finite = maxsim_ops.batched_maxsim_scores(tokens, counts, queries, metric=metric)
    scores = jnp.where(valid, totals, -jnp.inf)
    ok = jnp.all((jnp.isfinite(totals) & pair_finite) | ~valid)
    # slot order == id order (lex-sorted cache): stable top_k resolves ties
    # to the lexicographically smallest id (multi_vector.rs:22-31)
    top_scores, slots = jax.lax.top_k(scores, limit)
    return slots, top_scores, ok


_mv_pipeline = jax.jit(_mv_pipeline, static_argnames=("metric", "limit"))


def _mv_subset_pipeline(tokens, counts, slots, slot_ok, queries, *, metric, limit):
    sub_tokens = tokens[slots]
    sub_counts = jnp.where(slot_ok, counts[slots], 0)
    totals, pair_finite = maxsim_ops.batched_maxsim_scores(
        sub_tokens, sub_counts, queries, metric=metric
    )
    scores = jnp.where(slot_ok, totals, -jnp.inf)
    ok = jnp.all((jnp.isfinite(totals) & pair_finite) | ~slot_ok)
    k = min(limit, slots.shape[0])
    top_scores, pos = jax.lax.top_k(scores, k)
    return slots[pos], top_scores, ok


_mv_subset_pipeline = jax.jit(_mv_subset_pipeline, static_argnames=("metric", "limit"))


class Collection:
    """One vector collection: canonical host store + device acceleration."""

    def __init__(
        self,
        *,
        name=None,
        dimensions=None,
        metric="cosine",
        normalize=None,
        store="memory",
        index="flat",
        index_options=None,
        score="raw",
        compressed=False,
        mesh=None,
        **extra,
    ):
        _reject_extra(extra)
        metric = normalize_metric(metric)
        if normalize is None:
            normalize = default_normalize(metric)
        if not isinstance(dimensions, int) or isinstance(dimensions, bool) or dimensions <= 0:
            raise E.InvalidDimensions(f"invalid dimensions: {dimensions!r}")
        if metric not in METRICS:
            raise E.InvalidMetric(f"invalid metric: {metric!r}")
        if normalize not in NORMALIZATIONS:
            raise E.InvalidNormalization(f"invalid normalization: {normalize!r}")
        if score not in _SCORE_MODES:
            raise E.InvalidScoreMode(f"invalid score mode: {score!r}")
        if not isinstance(compressed, bool):
            raise E.VettoreError("compressed must be a boolean", reason="invalid_compressed")
        if index_options is not None and not isinstance(index_options, dict):
            raise E.InvalidIndexOptions("index_options must be a dict")

        self.name = name
        self.dimensions = dimensions
        self.metric = metric
        self.normalize = normalize
        self.score = score
        self.index_kind = index if isinstance(index, str) else "custom"
        self.index_options = dict(index_options or {})
        self.compressed = compressed
        self.mesh = mesh

        self._stats = StatsRegistry()
        self._index = self._make_index(index, metric, self.index_options, compressed,
                                       mesh=mesh)
        self._store = self._make_store(store, self._config())
        self._write_lock = threading.RLock()
        self._version = 0
        self._cache: _VectorCache | None = None
        self._cache_version = -1

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    @staticmethod
    def _make_index(index, metric, index_options, compressed=False, mesh=None):
        if mesh is not None and index in ("flat", "hnsw"):
            # collections larger than one chip shard across the mesh
            # (SURVEY §5.8): same Index behaviour, row-sharded device state
            from .parallel.collection_mesh import MeshFlatIndex, MeshHnswIndex

            if index == "flat":
                return MeshFlatIndex(metric, index_options or None, mesh=mesh,
                                     storage="bf16" if compressed else "f32")
            return MeshHnswIndex(metric, index_options, mesh=mesh)
        if index == "flat":
            # the reference's `compressed` trades CPU for ETS memory; the
            # device analog stores the block in bf16 (half the device
            # memory, bf16 tensor-core products)
            return FlatIndex(metric, index_options or None,
                             storage="bf16" if compressed else "f32")
        if index == "hnsw":
            from .index.hnsw import HnswIndex

            return HnswIndex(metric, index_options)
        if index == "ivf":
            if mesh is not None:
                from .parallel.ivf_mesh import MeshIvfIndex

                return MeshIvfIndex(metric, index_options, mesh=mesh)
            from .index.ivf import IvfIndex

            return IvfIndex(metric, index_options)
        if isinstance(index, type):
            instance = index(metric, index_options)
        else:
            instance = index
        if not valid_index(instance):
            raise E.InvalidIndex(f"invalid index: {index!r}")
        return instance

    @staticmethod
    def _make_store(store, config):
        compressed = bool(config.get("compressed"))
        if store == "memory":
            if compressed:
                # the reference's `compressed` cuts ETS (host) RAM
                # (store/ets.ex:273-282); the host analog is the columnar
                # store with bf16 halves — same rounding the compressed
                # device block scores with
                from .store.columnar import ColumnarStore

                return ColumnarStore(config, dtype="bf16")
            return MemoryStore(config)
        if store == "columnar":
            from .store.columnar import ColumnarStore

            return ColumnarStore(config, dtype="bf16" if compressed else "f32")
        if isinstance(store, type):
            instance = store(config)
        else:
            instance = store
        if not valid_store(instance):
            raise E.InvalidStore(f"invalid store: {store!r}")
        return instance

    def _config(self) -> dict:
        return {
            "snapshot_version": SNAPSHOT_VERSION,
            "name": self.name,
            "dimensions": self.dimensions,
            "metric": self.metric,
            "normalize": self.normalize,
            "score": self.score,
            "index": self.index_kind,
            "index_options": self.index_options,
            "compressed": self.compressed,
        }

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def ensure_open(self):
        alive = getattr(self._store, "alive", None)
        if callable(alive) and not alive():
            raise E.Closed("collection is closed")

    def close(self):
        close = getattr(self._store, "close", None)
        if callable(close):
            close()

    def stats(self) -> dict:
        """Snapshot of per-operation counters and latency aggregates.

        Search-mode timings are barrier-honest (those APIs device_get their
        results before returning). Ingest timings measure ENQUEUE time —
        device uploads/builds complete asynchronously; bracket with
        :meth:`sync` when honest end-to-end ingest latency matters."""
        return self._stats.snapshot()

    @observed("sync")
    def sync(self) -> None:
        """Barrier on the index's device state: returns only after every
        enqueued device mutation (uploads, graph waves) has executed."""
        index = self._index
        graph = getattr(index, "_bulk", None)
        if graph is not None and getattr(graph, "a0", None) is not None:
            jax.block_until_ready(graph.a0)
        dev = getattr(index, "_device", None)
        if isinstance(dev, tuple) and dev:
            jax.block_until_ready(dev[0])
        cache = self._cache
        if cache is not None and cache._x is not None:
            jax.block_until_ready(cache._x[0])

    @property
    def store(self) -> Store:
        return self._store

    @property
    def index(self) -> Index:
        return self._index

    def attach_index(self, index) -> None:
        """Expert API: swaps in a prebuilt acceleration index for the SAME
        record set — e.g. a graph cached via ``HnswIndex.save_graph`` and
        reloaded with ``load_graph`` (warm start; skips the bulk build). The
        canonical store is untouched; the index must hold exactly the
        collection's records."""
        if not valid_index(index):
            raise E.InvalidIndex(f"invalid index: {index!r}")
        with self._write_lock:
            self.ensure_open()
            n = self.count()
            try:
                index_n = len(index)
            except TypeError:
                index_n = n  # custom index without __len__: caller's contract
            if index_n != n:
                raise E.InvalidIndex(
                    f"attached index holds {index_n} records, collection has {n}"
                )
            self._index = index
            # the attached index defines the collection's kind (an hnsw
            # graph swapped over a flat-ingested collection enables the
            # hnsw hybrid generator, load_snapshot index overrides, etc.)
            from .index.hnsw import HnswIndex as _Hnsw
            from .index.ivf import IvfIndex as _Ivf

            if isinstance(index, FlatIndex):
                self.index_kind = "flat"
            elif isinstance(index, _Hnsw):
                self.index_kind = "hnsw"
            elif isinstance(index, _Ivf):
                self.index_kind = "ivf"
            else:
                self.index_kind = "custom"
            self._bump()

    def adopt_token_block(self, block_dev, *, sample: int = 32, seed: int = 0) -> None:
        """Expert API: adopts an already-resident ``[cap, T, d]`` device token
        block as the multi-vector scan cache, skipping the host→device token
        upload (the block is regenerable on device by deterministic corpus
        generators).

        The canonical tokens ALWAYS stay in the host store — ``sample`` docs
        are fetched from the block and verified bit-identical to the stored
        token rows before adoption (bf16 blocks verify against the high
        halves of the stored f32 tokens, lossless only when those are
        bf16-exact), and the padding planes are verified zero. ``sample >=
        n`` verifies every row. Any mismatch raises and leaves the normal
        upload path in place. The adopted block lives for one cache
        generation: any mutation rebuilds the cache from the canonical
        store."""
        if self.mesh is not None:
            raise E.InvalidMultiVector(
                "adopt_token_block is single-device only (mesh caches shard)")
        with self._write_lock:
            self.ensure_open()
            cache = self._scan_cache()
        if not cache.n:
            raise E.InvalidMultiVector("collection is empty")
        recs = cache.records
        first = recs[0].vectors
        if not (isinstance(first, np.ndarray) and first.ndim == 2 and all(
                isinstance(r.vectors, np.ndarray) and r.vectors.shape == first.shape
                for r in recs)):
            raise E.InvalidMultiVector(
                "adopt_token_block needs a uniform bulk-ingested token corpus")
        t = first.shape[0]
        t_max = _pow2_at_least(t, 1)
        if tuple(block_dev.shape) != (cache.cap, t_max, self.dimensions):
            raise E.InvalidMultiVector(
                f"device token block shape {tuple(block_dev.shape)} != "
                f"({cache.cap}, {t_max}, {self.dimensions})")
        if block_dev.dtype not in (jnp.bfloat16, jnp.float32):
            raise E.InvalidMultiVector("device token block must be bf16 or f32")
        if sample >= cache.n:  # full verification on request
            probe = np.arange(cache.n)
        else:
            rng = np.random.default_rng(seed)
            probe = np.unique(rng.integers(0, cache.n, size=sample))
        got = np.asarray(
            block_dev[jnp.asarray(probe.astype(np.int32))].astype(jnp.float32))
        want = np.stack([np.asarray(recs[i].vectors, np.float32) for i in probe])
        pads_zero = not (got[:, t:] != 0).any()
        got = np.ascontiguousarray(got[:, :t])
        if cache.cap > cache.n:
            tail = np.asarray(block_dev[cache.n].astype(jnp.float32))
            pads_zero = pads_zero and not (tail != 0).any()
        if got.shape != want.shape or (
                got.view(np.uint32) != want.view(np.uint32)).any():
            raise E.InvalidMultiVector(
                "device token block does not match the canonical store")
        if not pads_zero:
            raise E.InvalidMultiVector("device token block padding is not zero")
        counts = np.zeros(cache.cap, dtype=np.int32)
        counts[: cache.n] = t
        cache._mv = (block_dev, cache._put(counts))

    def _bump(self):
        self._version += 1

    def refresh(self):
        """Drops device scan caches (call after mutating a custom store
        directly, outside the collection API)."""
        self._bump()

    # ------------------------------------------------------------------
    # insert pipeline (collection.ex:920-1017)
    # ------------------------------------------------------------------

    def _prepare_one(self, item) -> Embedding:
        emb = Embedding.from_input(item)
        id = emb.id
        if not (isinstance(id, str) and id):
            if isinstance(emb.value, str) and emb.value:
                id = emb.value
            else:
                raise E.MissingId("embedding needs an id or a non-empty string value")

        vectors = None
        if emb.vectors is not None:
            if not isinstance(emb.vectors, (list, tuple)) or not emb.vectors:
                raise E.InvalidMultiVector("invalid multi vector")
            prepared = []
            for v in emb.vectors:
                self._validate_dims(v)
                prepared.append(normalize_rows(np.asarray(v, np.float64)[None, :], self.normalize)[0])
            vectors = prepared

        if emb.vector is not None:
            self._validate_dims(emb.vector)
            vector = normalize_rows(np.asarray(emb.vector, np.float64)[None, :], self.normalize)[0]
        elif vectors is not None:
            mean = np.mean(np.stack([v.astype(np.float64) for v in vectors]), axis=0)
            vector = normalize_rows(mean[None, :], self.normalize)[0]
        else:
            raise E.InvalidVector("embedding has no vector")

        binary = pack_signs_u64_rows(vector[None, :])[0]
        return Embedding(
            id=id,
            value=emb.value if emb.value is not None else id,
            vector=vector,
            vectors=vectors,
            binary_vector=[int(w) for w in binary],
            metadata=emb.metadata,
        )

    def _prepare_batch(self, items) -> list:
        """Batch insert preparation. Large homogeneous batches (plain
        single-vector records) take a vectorized path — one matrix validate /
        normalize / sign-pack instead of per-record Python work — which is
        what makes million-row ingest tractable."""
        if len(items) < 256:
            return [self._prepare_one(i) for i in items]
        simple = []
        for item in items:
            if isinstance(item, Embedding):
                if item.vectors is not None or item.vector is None:
                    return self._prepare_batch_multi(items)
                id = item.id if isinstance(item.id, str) and item.id else (
                    item.value if isinstance(item.value, str) and item.value else None
                )
                if id is None:
                    raise E.MissingId("embedding needs an id or a non-empty string value")
                simple.append((id, item.value if item.value is not None else id,
                               item.vector, item.metadata))
            else:
                if "vectors" in item or "vector" not in item:
                    return self._prepare_batch_multi(items)
                id = item.get("id") or item.get("value")
                if not isinstance(id, str) or not id:
                    raise E.MissingId("embedding needs an id or a non-empty string value")
                simple.append((id, item.get("value", id), item["vector"],
                               item.get("metadata")))
        try:
            matrix = np.asarray([row[2] for row in simple], dtype=np.float64)
        except (TypeError, ValueError) as exc:
            raise E.InvalidVector("vector must be numeric") from exc
        if matrix.ndim != 2 or matrix.shape[1] != self.dimensions:
            raise E.DimensionMismatch("dimension mismatch")
        if not np.isfinite(matrix).all() or (np.abs(matrix) > F32_MAX).any():
            raise E.InvalidVector("vector contains a non-finite value")
        normalized = normalize_rows(matrix, self.normalize)
        packed = pack_signs_u64_rows(normalized)
        return [
            Embedding(id=id, value=value, vector=normalized[i],
                      vectors=None, binary_vector=[int(w) for w in packed[i]],
                      metadata=metadata)
            for i, (id, value, _vec, metadata) in enumerate(simple)
        ]

    def _prepare_batch_multi(self, items) -> list:
        """Vectorized preparation for homogeneous MULTI-vector batches (every
        record carries ``vectors`` with the same token count and no explicit
        primary vector): one [N*T, d] validate/normalize + one batched mean +
        sign-pack instead of per-record Python. Anything ragged or mixed
        falls back to the per-record path."""
        rows = []
        for item in items:
            if isinstance(item, Embedding):
                if item.vector is not None or not item.vectors:
                    return [self._prepare_one(i) for i in items]
                id = item.id if isinstance(item.id, str) and item.id else (
                    item.value if isinstance(item.value, str) and item.value else None
                )
                if id is None:
                    raise E.MissingId("embedding needs an id or a non-empty string value")
                rows.append((id, item.value if item.value is not None else id,
                             item.vectors, item.metadata))
            else:
                if "vector" in item or not item.get("vectors"):
                    return [self._prepare_one(i) for i in items]
                id = item.get("id") or item.get("value")
                if not isinstance(id, str) or not id:
                    raise E.MissingId("embedding needs an id or a non-empty string value")
                rows.append((id, item.get("value", id), item["vectors"],
                             item.get("metadata")))
        t0 = len(rows[0][2]) if isinstance(rows[0][2], (list, tuple)) else -1
        if t0 <= 0 or not all(
            isinstance(r[2], (list, tuple)) and len(r[2]) == t0 for r in rows
        ):
            return [self._prepare_one(i) for i in items]
        try:
            tokens = np.asarray([r[2] for r in rows], dtype=np.float64)
        except (TypeError, ValueError):
            return [self._prepare_one(i) for i in items]
        if tokens.ndim != 3 or tokens.shape[2] != self.dimensions:
            raise E.DimensionMismatch("dimension mismatch")
        if not np.isfinite(tokens).all() or (np.abs(tokens) > F32_MAX).any():
            raise E.InvalidVector("vector contains a non-finite value")
        n, t, d = tokens.shape
        normalized = normalize_rows(tokens.reshape(n * t, d), self.normalize)
        normalized = normalized.reshape(n, t, d)
        # mean in f64 over the (f32) normalized tokens — byte parity with
        # _prepare_one's per-record pipeline
        primary = normalize_rows(
            normalized.astype(np.float64).mean(axis=1), self.normalize
        )
        packed = pack_signs_u64_rows(primary)
        return [
            Embedding(id=id, value=value,
                      vector=primary[i],
                      vectors=[normalized[i, j] for j in range(t)],
                      binary_vector=[int(w) for w in packed[i]],
                      metadata=metadata)
            for i, (id, value, _vs, metadata) in enumerate(rows)
        ]

    def _validate_dims(self, vector):
        if not isinstance(vector, (list, tuple, np.ndarray)):
            raise E.InvalidVector("vector must be a list")
        if len(vector) != self.dimensions:
            raise E.DimensionMismatch("dimension mismatch")
        validate_vector(list(vector) if not isinstance(vector, np.ndarray) else vector)

    def put(self, item) -> None:
        """Inserts or replaces one record (dict or :class:`Embedding`).

        >>> import vettore_tpu as vt
        >>> col = vt.Collection(name="doc-put", dimensions=2, index="flat")
        >>> col.put({"id": "a", "vector": [1.0, 0.0], "metadata": {"k": 1}})
        >>> col.get("a").metadata
        {'k': 1}
        >>> col.count()
        1
        >>> col.close()
        """
        self.put_many([item])

    @observed("put_many")
    def put_many(self, items: Iterable) -> None:
        items = list(items)
        if not all(isinstance(i, (dict, Embedding)) for i in items):
            raise E.InvalidEmbedding("invalid embeddings")
        prepared = self._prepare_batch(items)
        with self._write_lock:
            self.ensure_open()
            self._store.put_many(prepared)
            try:
                self._index.put_many([(e.id, e.vector) for e in prepared])
            except Exception:
                for e in prepared:
                    self._index.delete(e.id)
                    self._store.delete(e.id)
                raise
            finally:
                self._bump()

    @observed("put_matrix")
    def put_matrix(self, ids, matrix, *, values=None, metadata=None) -> None:
        """Bulk ingest from an [n, d] matrix with one row per id — the
        million-row path (vectorized validate / normalize / sign-pack; no
        per-record Python). Per-record ``binary_vector`` is stored as a
        uint64 ndarray row (accepted everywhere a word list is)."""
        matrix = np.asarray(matrix)
        if matrix.dtype.kind not in "iuf":
            matrix = matrix.astype(np.float64)  # rejects non-numeric input
        if matrix.ndim != 2:
            raise E.InvalidVector("matrix must be [n, d]")
        if matrix.shape[1] != self.dimensions:
            raise E.DimensionMismatch("dimension mismatch")
        if len(ids) != matrix.shape[0]:
            raise E.InvalidVector("ids and matrix row count differ")
        # validity is dtype-independent: check the input in place instead of
        # materializing a full-matrix f64 copy first (normalize_rows does its
        # f64 math in bounded row chunks)
        if not np.isfinite(matrix).all() or (np.abs(matrix) > F32_MAX).any():
            raise E.InvalidVector("vector contains a non-finite value")
        ids = [str(i) for i in ids]
        if any(not i for i in ids):
            raise E.MissingId("embedding needs an id or a non-empty string value")
        normalized = normalize_rows(matrix, self.normalize)
        packed = pack_signs_u64_rows(normalized)
        prepared = [
            Embedding(
                id=id,
                value=(values[i] if values is not None else id),
                vector=normalized[i],
                vectors=None,
                binary_vector=packed[i],
                metadata=(metadata[i] if metadata is not None else None),
            )
            for i, id in enumerate(ids)
        ]
        with self._write_lock:
            self.ensure_open()
            self._store.put_many(prepared)
            try:
                index_bulk = getattr(self._index, "put_matrix", None)
                if callable(index_bulk) and not any(
                    i in getattr(self._index, "_slot_of", {}) for i in ids
                ):
                    index_bulk(ids, normalized.astype(np.float32, copy=False))
                else:
                    self._index.put_many([(e.id, e.vector) for e in prepared])
            except Exception:
                for e in prepared:
                    self._index.delete(e.id)
                    self._store.delete(e.id)
                raise
            finally:
                self._bump()

    @observed("put_tokens")
    def put_tokens(self, ids, tokens, *, values=None, metadata=None) -> None:
        """Bulk multi-vector ingest from an [n, t, d] token block — the
        million-document ColBERT path. Semantics match ``put_many`` with
        ``vectors`` records (primary = normalized mean of the normalized
        tokens, auto sign packing; collection.ex:1008-1017), but the whole
        batch is one vectorized validate / normalize / mean / sign-pack.
        Stored ``vectors`` are [t, d] f32 ndarrays (accepted everywhere a
        row list is)."""
        tokens = np.asarray(tokens)
        if tokens.dtype.kind not in "iuf":
            tokens = tokens.astype(np.float64)  # rejects non-numeric input
        if tokens.ndim != 3 or tokens.shape[1] == 0:
            raise E.InvalidMultiVector("tokens must be [n, t, d]")
        if tokens.shape[2] != self.dimensions:
            raise E.DimensionMismatch("dimension mismatch")
        if len(ids) != tokens.shape[0]:
            raise E.InvalidVector("ids and token row count differ")
        if not np.isfinite(tokens).all() or (np.abs(tokens) > F32_MAX).any():
            raise E.InvalidVector("vector contains a non-finite value")
        ids = [str(i) for i in ids]
        if any(not i for i in ids):
            raise E.MissingId("embedding needs an id or a non-empty string value")
        n, t, d = tokens.shape
        normalized = normalize_rows(
            tokens.reshape(n * t, d), self.normalize
        ).reshape(n, t, d)
        # mean accumulated in f64 straight off the f32 block (np.mean
        # upcasts per element — identical values to astype(f64).mean()
        # without the 2x-size intermediate copy); byte parity with
        # _prepare_batch_multi / _prepare_one
        primary = normalize_rows(
            normalized.mean(axis=1, dtype=np.float64), self.normalize
        )
        packed = pack_signs_u64_rows(primary)
        prepared = [
            Embedding(
                id=id,
                value=(values[i] if values is not None else id),
                vector=primary[i],
                vectors=normalized[i],
                binary_vector=packed[i],
                metadata=(metadata[i] if metadata is not None else None),
            )
            for i, id in enumerate(ids)
        ]
        with self._write_lock:
            self.ensure_open()
            self._store.put_many(prepared)
            try:
                index_bulk = getattr(self._index, "put_matrix", None)
                if callable(index_bulk) and not any(
                    i in getattr(self._index, "_slot_of", {}) for i in ids
                ):
                    index_bulk(ids, primary.astype(np.float32, copy=False))
                else:
                    self._index.put_many([(e.id, e.vector) for e in prepared])
            except Exception:
                for e in prepared:
                    self._index.delete(e.id)
                    self._store.delete(e.id)
                raise
            finally:
                self._bump()

    def get(self, id: str) -> Embedding:
        if not isinstance(id, str):
            raise E.VettoreError("invalid id", reason="invalid_id")
        return self._store.get(id)

    @observed("delete")
    def delete(self, id: str) -> None:
        if not isinstance(id, str):
            raise E.VettoreError("invalid id", reason="invalid_id")
        with self._write_lock:
            self.ensure_open()
            try:
                embedding = self._store.get(id)
            except E.NotFound:
                self._index.delete(id)
                self._bump()
                return
            self._index.delete(id)
            try:
                self._store.delete(id)
            except Exception as store_error:
                try:
                    self._index.put(id, embedding.vector)
                except Exception as index_error:
                    raise E.IndexRestoreFailed(store_error, index_error) from store_error
                raise
            finally:
                self._bump()

    def all(self) -> list:
        self.ensure_open()
        return self._store.all()

    def count(self) -> int:
        self.ensure_open()
        count = getattr(self._store, "count", None)
        return count() if callable(count) else len(self._store.all())

    # ------------------------------------------------------------------
    # query preparation
    # ------------------------------------------------------------------

    def prepare_query(self, query) -> np.ndarray:
        self.ensure_open()
        self._validate_dims(query)
        return normalize_rows(np.asarray(query, np.float64)[None, :], self.normalize)[0]

    def _prepare_query_vectors(self, query_vectors) -> np.ndarray:
        if not isinstance(query_vectors, (list, tuple)) or not query_vectors:
            raise E.InvalidMultiVector("invalid multi vector")
        rows = []
        for v in query_vectors:
            self._validate_dims(v)
            rows.append(normalize_rows(np.asarray(v, np.float64)[None, :], self.normalize)[0])
        return np.stack(rows)

    def _scan_cache(self) -> _VectorCache:
        if self._cache is None or self._cache_version != self._version:
            cache = _VectorCache(self._store.all(), self.dimensions,
                                 mesh=self.mesh)
            self._try_share_block(cache)
            self._cache = cache
            self._cache_version = self._version
        return self._cache

    def _try_share_block(self, cache: _VectorCache) -> None:
        """Shares the flat index's device block with the scan cache when slot
        order equals lex id order (true after a sorted bulk ingest) — saves a
        second multi-GB host→device transfer of the same vectors."""
        idx = self._index
        if not (
            isinstance(idx, FlatIndex)
            and idx.storage == "f32"
            and cache.n
            and len(idx) == cache.n
            and idx.dimension == self.dimensions
        ):
            return
        if idx._cap != cache.cap or not idx._valid[: cache.n].all() or idx._valid[cache.n:].any():
            return
        if idx._ids[: cache.n] != cache.ids:
            return
        idx._sync_device()
        x, valid, _ = idx._device
        cache._x = (x, valid)

    # ------------------------------------------------------------------
    # result hydration
    # ------------------------------------------------------------------

    def _to_result(self, embedding: Embedding, raw: float) -> Result:
        score, distance = result_values(self.metric, raw, self.score)
        return Result(
            id=embedding.id,
            value=embedding.value,
            score=score,
            distance=distance,
            metric=self.metric,
            metadata=embedding.metadata,
        )

    def _hydrate_hits(self, hits) -> list:
        results = []
        for id, raw in hits:
            try:
                embedding = self._store.get(id)
            except E.NotFound:
                continue
            results.append(self._to_result(embedding, raw))
        return results

    # ------------------------------------------------------------------
    # search modes
    # ------------------------------------------------------------------

    @observed("search")
    def search(self, query, *, limit=10, **extra) -> list:
        """Index search (exact flat scan or HNSW ANN).

        >>> import vettore_tpu as vt
        >>> col = vt.Collection(name="doc-search", dimensions=2,
        ...                     metric="cosine", index="flat")
        >>> col.put_many([{"id": "east", "vector": [1.0, 0.0]},
        ...               {"id": "north", "vector": [0.0, 1.0]}])
        >>> [r.id for r in col.search([0.9, 0.1], limit=2)]
        ['east', 'north']
        >>> round(col.search([1.0, 0.0], limit=1)[0].score, 3)
        1.0
        >>> col.close()
        """
        _reject_extra(extra)
        _validate_limit(limit)
        q = self.prepare_query(query)
        hits = self._index.search(q, limit)
        return self._hydrate_hits(hits)

    @observed("search_batch")
    def search_batch(self, queries, *, limit=10, **extra) -> list:
        """Batched index search: one device dispatch for a query batch."""
        _reject_extra(extra)
        _validate_limit(limit)
        self.ensure_open()
        if len(queries):
            try:
                qs = np.asarray(queries, dtype=np.float64)
            except (TypeError, ValueError) as exc:
                raise E.InvalidVector("queries must be numeric") from exc
            if qs.ndim != 2:
                raise E.InvalidVector("queries must be a [batch, dims] matrix")
            if qs.shape[1] != self.dimensions:
                raise E.DimensionMismatch("dimension mismatch")
            if not np.isfinite(qs).all() or (np.abs(qs) > F32_MAX).any():
                raise E.InvalidVector("vector contains a non-finite value")
            prepared = normalize_rows(qs, self.normalize)
        else:
            prepared = np.zeros((0, self.dimensions), np.float32)
        batch = getattr(self._index, "search_batch", None)
        if callable(batch):
            all_hits = batch(prepared, limit)
        else:
            all_hits = [self._index.search(q, limit) for q in prepared]
        return [self._hydrate_hits(hits) for hits in all_hits]

    @observed("funnel_search")
    def funnel_search(self, query, *, limit=10, candidates=None, stages=None, dimensions=None,
                      **extra) -> list:
        """Matryoshka funnel: prefix-staged candidate narrowing + exact rerank
        (collection.ex:244-260,660-691).

        >>> import vettore_tpu as vt
        >>> col = vt.Collection(name="doc-funnel", dimensions=4,
        ...                     metric="cosine", index="flat")
        >>> col.put_many([{"id": "a", "vector": [1.0, 0.0, 0.0, 0.0]},
        ...               {"id": "b", "vector": [0.0, 1.0, 0.0, 0.0]}])
        >>> [r.id for r in col.funnel_search([1.0, 0.1, 0.0, 0.0],
        ...                                  stages=[2, 4], limit=1)]
        ['a']
        >>> col.close()
        """
        _reject_extra(extra)
        _validate_limit(limit)
        if candidates is None:
            candidates = max(limit * 10, limit)
        _validate_candidates(candidates, limit)
        stages = self._funnel_stages(stages, dimensions)
        q = self.prepare_query(query)
        if self.mesh is not None:
            # one query rides the sharded batch pipeline (SURVEY §5.8);
            # raw query, so normalization is applied exactly once
            return self.funnel_search_batch(
                np.asarray(query, np.float64)[None, :], limit=limit,
                candidates=candidates, stages=list(stages))[0]
        cache = self._scan_cache()
        if cache.n == 0:
            return []
        x, valid = cache.vectors()
        count = min(candidates, cache.n)
        k = min(limit, count)
        top, raws, ranks, finite = pipe.funnel_pipeline(
            x, valid, jnp.asarray(q),
            metric=self.metric, stages=tuple(stages), count=count, limit=k,
        )
        top, raws, ranks, finite = jax.device_get((top, raws, ranks, finite))
        if not bool(finite):
            return self._funnel_host(cache, q, stages, candidates, limit)
        return self._slots_to_results(cache, top, raws, ranks)

    @observed("funnel_search_batch")
    def funnel_search_batch(self, queries, *, limit=10, candidates=None, stages=None,
                            dimensions=None, **extra) -> list:
        """Batched funnel search: one device dispatch for a query batch."""
        _reject_extra(extra)
        _validate_limit(limit)
        if candidates is None:
            candidates = max(limit * 10, limit)
        _validate_candidates(candidates, limit)
        stages = self._funnel_stages(stages, dimensions)
        prepared = self._prepare_query_batch(queries)
        cache = self._scan_cache()
        if cache.n == 0:
            return [[] for _ in range(prepared.shape[0])]
        if prepared.shape[0] == 0:
            return []
        x, valid = cache.vectors()
        count = min(candidates, cache.n)
        k = min(limit, count)
        if self.mesh is not None:
            from .parallel import adaptive_mesh as amesh

            qp, B = self._mesh_pad_queries(prepared)
            top, raws, ranks, finite = jax.device_get(amesh.sharded_funnel_topk(
                self.mesh, x, valid, jnp.asarray(qp),
                metric=self.metric, stages=tuple(stages), count=count, limit=k,
            ))
        else:
            B = prepared.shape[0]
            # bf16-exact query batches ship as u16 halves (half the
            # host-to-device bytes)
            top, raws, ranks, finite = jax.device_get(pipe.funnel_pipeline_batch(
                x, valid, put_f32_matrix(prepared),
                metric=self.metric, stages=tuple(stages), count=count, limit=k,
            ))
        out = []
        for b in range(B):
            if not bool(finite[b]):
                out.append(self._funnel_host(cache, prepared[b], stages, candidates, limit))
            else:
                out.append(self._slots_to_results(cache, top[b], raws[b], ranks[b]))
        return out

    def _mesh_pad_queries(self, prepared: np.ndarray):
        """Pads a prepared query batch to a multiple of the mesh's ``data``
        axis (shard_map requires evenly divisible batch shards); returns
        ``(padded, real_count)``."""
        data = self.mesh.shape["data"]
        B = prepared.shape[0]
        pad = (-B) % data
        if pad:
            prepared = np.concatenate(
                [prepared, np.zeros((pad, prepared.shape[1]), np.float32)])
        return prepared.astype(np.float32, copy=False), B

    @observed("quantized_search_batch")
    def quantized_search_batch(self, queries, *, limit=10, candidates=None, **extra) -> list:
        """Batched quantized search: one device dispatch for a query batch."""
        _reject_extra(extra)
        _validate_limit(limit)
        if candidates is None:
            candidates = max(limit * 10, limit)
        _validate_candidates(candidates, limit)
        prepared = self._prepare_query_batch(queries)
        cache = self._scan_cache()
        if cache.n == 0:
            return [[] for _ in range(prepared.shape[0])]
        if prepared.shape[0] == 0:
            return []
        x, valid = cache.vectors()
        signs = cache.signs()
        count = min(candidates, cache.n)
        k = min(limit, count)
        if self.mesh is not None:
            from .parallel import adaptive_mesh as amesh

            qp, B = self._mesh_pad_queries(prepared)
            top, raws, ranks, finite = jax.device_get(amesh.sharded_quantized_topk(
                self.mesh, x, signs, valid, jnp.asarray(qp),
                metric=self.metric, count=count, limit=k, d=self.dimensions,
            ))
        else:
            B = prepared.shape[0]
            top, raws, ranks, finite = jax.device_get(pipe.quantized_pipeline_batch(
                x, signs, valid, put_f32_matrix(prepared),
                metric=self.metric, count=count, limit=k, d=self.dimensions,
            ))
        out = []
        for b in range(B):
            if not bool(finite[b]):
                out.append(self._quantized_host(cache, prepared[b], candidates, limit))
            else:
                out.append(self._slots_to_results(cache, top[b], raws[b], ranks[b]))
        return out

    def funnel_search_batch_device(self, queries_device, *, limit=10,
                                   candidates=None, stages=None,
                                   dimensions=None):
        """Device-to-device funnel search: takes a resident [B, d] f32
        PREPARED query block (caller owns validation/normalization — see
        ``prepare_query``), returns ``(slots, raws, ranks, ok)`` device
        arrays with no host transfer. The serving/pipelining path, like
        ``FlatIndex.search_batch_device``; hydrate with
        ``results_from_device``. On a mesh the batch must be a multiple of
        the ``data`` axis."""
        _validate_limit(limit)
        if candidates is None:
            candidates = max(limit * 10, limit)
        _validate_candidates(candidates, limit)
        stages = self._funnel_stages(stages, dimensions)
        self.ensure_open()
        cache = self._scan_cache()
        x, valid = cache.vectors()
        count = min(candidates, max(cache.n, 1))
        k = min(limit, count)
        if self.mesh is not None:
            from .parallel import adaptive_mesh as amesh

            return amesh.sharded_funnel_topk(
                self.mesh, x, valid, queries_device,
                metric=self.metric, stages=tuple(stages), count=count, limit=k)
        return pipe.funnel_pipeline_batch(
            x, valid, queries_device,
            metric=self.metric, stages=tuple(stages), count=count, limit=k)

    def quantized_search_batch_device(self, queries_device, *, limit=10,
                                      candidates=None):
        """Device-to-device quantized search; same contract as
        ``funnel_search_batch_device``."""
        _validate_limit(limit)
        if candidates is None:
            candidates = max(limit * 10, limit)
        _validate_candidates(candidates, limit)
        self.ensure_open()
        cache = self._scan_cache()
        x, valid = cache.vectors()
        signs = cache.signs()
        count = min(candidates, max(cache.n, 1))
        k = min(limit, count)
        if self.mesh is not None:
            from .parallel import adaptive_mesh as amesh

            return amesh.sharded_quantized_topk(
                self.mesh, x, signs, valid, queries_device,
                metric=self.metric, count=count, limit=k, d=self.dimensions)
        return pipe.quantized_pipeline_batch(
            x, signs, valid, queries_device,
            metric=self.metric, count=count, limit=k, d=self.dimensions)

    def results_from_device(self, out) -> list:
        """Hydrates a ``(slots, raws, ranks, ok)`` device tuple from a
        ``*_search_batch_device`` call into per-query Result lists. Rows
        whose ``ok`` flag is False (f32 overflow or selection spill) come
        back as ``None`` — the sync batch APIs route those to the host
        oracle instead."""
        top, raws, ranks, finite = jax.device_get(out)
        cache = self._scan_cache()
        return [
            self._slots_to_results(cache, top[b], raws[b], ranks[b])
            if bool(finite[b]) else None
            for b in range(top.shape[0])
        ]

    def _prepare_query_batch(self, queries) -> np.ndarray:
        self.ensure_open()
        if not len(queries):
            return np.zeros((0, self.dimensions), np.float32)
        try:
            qs = np.asarray(queries, dtype=np.float64)
        except (TypeError, ValueError) as exc:
            raise E.InvalidVector("queries must be numeric") from exc
        if qs.ndim != 2:
            raise E.InvalidVector("queries must be a [batch, dims] matrix")
        if qs.shape[1] != self.dimensions:
            raise E.DimensionMismatch("dimension mismatch")
        if qs.size and (not np.isfinite(qs).all() or (np.abs(qs) > F32_MAX).any()):
            raise E.InvalidVector("vector contains a non-finite value")
        return normalize_rows(qs, self.normalize) if qs.size else qs

    def _funnel_stages(self, stages, dimensions):
        if stages is None:
            stages = [dimensions] if dimensions is not None else [min(self.dimensions, 128)]
        if not isinstance(stages, (list, tuple)) or not stages or not all(
            isinstance(s, int) and not isinstance(s, bool) and 0 < s <= self.dimensions
            for s in stages
        ):
            raise E.InvalidStages(f"invalid stages: {stages!r}")
        return list(stages)

    def _funnel_host(self, cache, q, stages, candidates, limit):
        pairs = [(r.id, np.asarray(r.vector)) for r in cache.records]
        for dims in stages:
            hits = scan_host.vector_top_k(pairs, q, self.metric, dims, candidates)
            keep = {id for id, _ in hits}
            by_id = {id: v for id, v in pairs}
            pairs = [(id, by_id[id]) for id, _ in hits if id in keep]
        hits = scan_host.vector_top_k(pairs, q, self.metric, self.dimensions, limit)
        return [self._to_result(cache.by_id[id], raw) for id, raw in hits]

    @observed("quantized_search")
    def quantized_search(self, query, *, limit=10, candidates=None, **extra) -> list:
        """Sign-bit Hamming candidates + exact rerank (collection.ex:274-295).

        >>> import vettore_tpu as vt
        >>> col = vt.Collection(name="doc-quant", dimensions=4,
        ...                     metric="cosine", index="flat")
        >>> col.put_many([{"id": "pos", "vector": [1.0, 1.0, 1.0, 1.0]},
        ...               {"id": "neg", "vector": [-1.0, -1.0, -1.0, -1.0]}])
        >>> [r.id for r in col.quantized_search([1.0, 1.0, 0.9, 1.0],
        ...                                     candidates=2, limit=1)]
        ['pos']
        >>> col.close()
        """
        _reject_extra(extra)
        _validate_limit(limit)
        if candidates is None:
            candidates = max(limit * 10, limit)
        _validate_candidates(candidates, limit)
        q = self.prepare_query(query)
        if self.mesh is not None:
            # raw query: normalization must be applied exactly once
            return self.quantized_search_batch(
                np.asarray(query, np.float64)[None, :], limit=limit,
                candidates=candidates)[0]
        cache = self._scan_cache()
        if cache.n == 0:
            return []
        x, valid = cache.vectors()
        signs = cache.signs()
        count = min(candidates, cache.n)
        k = min(limit, count)
        top, raws, ranks, finite = pipe.quantized_pipeline(
            x, signs, valid, jnp.asarray(q),
            metric=self.metric, count=count, limit=k, d=self.dimensions,
        )
        top, raws, ranks, finite = jax.device_get((top, raws, ranks, finite))
        if not bool(finite):
            return self._quantized_host(cache, q, candidates, limit)
        return self._slots_to_results(cache, top, raws, ranks)

    def _quantized_host(self, cache, q, candidates, limit):
        qwords = [int(w) for w in pack_signs_u64_rows(q[None, :])[0]]
        pairs = []
        for r in cache.records:
            words = [int(w) for w in r.binary_vector] if r.binary_vector is not None else [
                int(w) for w in pack_signs_u64_rows(np.asarray(r.vector, np.float64)[None, :])[0]
            ]
            pairs.append((r.id, words))
        hits = scan_host.binary_top_k(pairs, qwords, self.dimensions, candidates)
        survivors = [(id, np.asarray(cache.by_id[id].vector)) for id, _ in hits]
        final = scan_host.vector_top_k(survivors, q, self.metric, self.dimensions, limit)
        return [self._to_result(cache.by_id[id], raw) for id, raw in final]

    @observed("multi_vector_search")
    def multi_vector_search(self, query_vectors, *, limit=10, metric=None,
                            candidates=None, muvera=None, **extra) -> list:
        """ColBERT MaxSim late interaction over multi-vector records
        (collection.ex:311-323,742-760).

        ``candidates`` (extension beyond the reference): route through the MUVERA FDE
        candidate generator (muvera.rs:26-74 encodings built on device at
        ingest) and exact-MaxSim-rerank only the top-``candidates`` docs —
        ~25x fewer FLOPs than the exact sweep at 1M x 32 x 128. ``muvera``
        optionally overrides the FDE config (same keys as the public
        encoders). Omitted = the exact full scan.

        >>> import vettore_tpu as vt
        >>> col = vt.Collection(name="doc-mv", dimensions=2, metric="cosine")
        >>> col.put_many([
        ...     {"id": "a", "vectors": [[1.0, 0.0], [0.9, 0.1]]},
        ...     {"id": "b", "vectors": [[0.0, 1.0]]},
        ... ])
        >>> res = col.multi_vector_search([[1.0, 0.0]], limit=2)
        >>> [r.id for r in res]
        ['a', 'b']
        >>> round(res[0].score, 2)  # best token similarity, summed
        1.0
        >>> col.close()
        """
        _reject_extra(extra)
        _validate_limit(limit)
        metric = normalize_metric(metric) if metric is not None else self.metric
        if metric not in METRICS:
            raise E.InvalidMetric(f"invalid metric: {metric!r}")
        self.ensure_open()
        queries = self._prepare_query_vectors(query_vectors)
        if candidates is not None or muvera is not None:
            return self.multi_vector_search_batch(
                [query_vectors], limit=limit, metric=metric,
                candidates=candidates, muvera=muvera)[0]
        if self.mesh is not None:
            return self.multi_vector_search_batch(
                [query_vectors], limit=limit, metric=metric)[0]
        cache = self._scan_cache()
        if cache.n == 0:
            return []
        tokens, counts = cache.multi_vectors()
        _x, valid = cache.vectors()
        k = min(limit, cache.n)
        slots, scores, ok = _mv_pipeline(
            tokens, counts, valid, jnp.asarray(queries), metric=metric, limit=k
        )
        slots, scores, ok = jax.device_get((slots, scores, ok))
        if not bool(ok):
            return self._multi_vector_host(cache, query_vectors, queries, metric, limit)
        results = []
        for slot, score in zip(slots, scores):
            if not np.isfinite(score):
                continue
            r = cache.records[int(slot)]
            results.append(
                Result(id=r.id, value=r.value, score=float(score), distance=None,
                       metric=metric, metadata=r.metadata)
            )
        return results

    def _multi_vector_host(self, cache, _raw_queries, queries, metric, limit):
        documents = []
        for r in cache.records:
            vs = r.vectors if _has_tokens(r.vectors) else [r.vector]
            documents.append((r.id, [list(np.asarray(v, np.float64)) for v in vs]))
        hits = maxsim_ops.top_k(documents, [list(q) for q in queries], metric, limit)
        return [
            Result(id=id, value=cache.by_id[id].value, score=score, distance=None,
                   metric=metric, metadata=cache.by_id[id].metadata)
            for id, score in hits
        ]

    def _pad_query_sets(self, query_sets):
        """Prepares a batch of ragged query token sets: returns
        ``(qtok [B, Qmax, d] f32, qmask [B, Qmax] bool)`` with Qmax bucketed
        to a power of two (bounds recompiles across varying token counts)."""
        per = [self._prepare_query_vectors(qs) for qs in query_sets]
        qmax = _pow2_at_least(max(p.shape[0] for p in per), 1)
        qtok = np.zeros((len(per), qmax, self.dimensions), np.float32)
        qmask = np.zeros((len(per), qmax), bool)
        for i, p in enumerate(per):
            qtok[i, : p.shape[0]] = p
            qmask[i, : p.shape[0]] = True
        return qtok, qmask

    def _mv_fde_pipeline(self, cache, tokens, counts, qtok, qmask, *, metric,
                         candidates, cfg, k):
        """MUVERA candidate generation + exact subset rerank: bit-exact
        host-encoded query FDEs (the public encoder, muvera.rs sum mode),
        one device FDE-block scan for the top-C slots, then exact MaxSim of
        the C winners (storage-exact scores, (score desc, slot asc) order).
        Returns host ``(slots [B, k], scores [B, k], ok [B])``."""
        from .ops import muvera_fde

        fde16, fde_bias = cache.fde(cfg)
        b = qtok.shape[0]
        qfde = np.zeros((b, int(fde16.shape[1])), np.float32)
        nonempty = [i for i in range(b) if qmask[i].any()]
        if nonempty:
            # empty query sets keep the zero FDE: every doc ranks 0 and the
            # exact rerank scores them 0.0, the reference's empty-side rule
            enc = muvera_fde.encode_query_sets_host(
                [qtok[i][qmask[i]] for i in nonempty], cfg)
            for row, i in zip(enc, nonempty):
                qfde[i] = row
        c_eff = min(_pow2_at_least(candidates, 64), cache.cap)
        cand_slots, cand_ok = muvera_fde.fde_candidates(
            fde16, fde_bias, jnp.asarray(qfde), count=c_eff)
        slot_ok = cand_slots >= 0
        # bound the [B, C, T, d] rerank gather by chunking the query batch
        t, d = int(tokens.shape[1]), int(tokens.shape[2])
        per_q = c_eff * t * d * tokens.dtype.itemsize
        qchunk = max(1, min(b, (512 * 2**20) // max(per_q, 1)))
        qtok_dev, qmask_dev = jnp.asarray(qtok), jnp.asarray(qmask)
        parts = []
        for s in range(0, b, qchunk):
            e = min(b, s + qchunk)
            parts.append(maxsim_ops.maxsim_subset_topk_batch(
                tokens, counts, jnp.maximum(cand_slots[s:e], 0), slot_ok[s:e],
                qtok_dev[s:e], qmask_dev[s:e], metric=metric, limit=k))
        slots = jnp.concatenate([p[0] for p in parts])
        scores = jnp.concatenate([p[1] for p in parts])
        ok = jnp.concatenate([p[2] for p in parts]) & cand_ok
        return jax.device_get((slots, scores, ok))

    def _mv_slots_to_results(self, cache, slots, scores, metric) -> list:
        results = []
        for slot, score in zip(slots, scores):
            if slot < 0 or not np.isfinite(score):
                continue
            r = cache.records[int(slot)]
            results.append(
                Result(id=r.id, value=r.value, score=float(score), distance=None,
                       metric=metric, metadata=r.metadata)
            )
        return results

    @observed("multi_vector_search_batch")
    def multi_vector_search_batch(self, query_sets, *, limit=10, metric=None,
                                  candidates=None, muvera=None, **extra) -> list:
        """Batched ColBERT MaxSim over the full corpus: one query token set
        per batch element (ragged ok), one chunked device scan for the whole
        batch. Doc chunks stream through the similarity kernel, so the corpus
        is bounded by the token block's HBM footprint (bf16-resident when
        lossless), not by any [D, Q, T] intermediate.

        ``candidates``/``muvera``: MUVERA-FDE candidate generation + exact
        subset rerank (see :meth:`multi_vector_search`). On a mesh the
        sharded exact scan serves these requests (a strict quality upper
        bound of the approximate path)."""
        _reject_extra(extra)
        _validate_limit(limit)
        metric = normalize_metric(metric) if metric is not None else self.metric
        if metric not in METRICS:
            raise E.InvalidMetric(f"invalid metric: {metric!r}")
        fde_cfg = None
        if candidates is not None:
            from .ops import muvera_fde

            if (not isinstance(candidates, int) or isinstance(candidates, bool)
                    or candidates <= 0):
                raise E.InvalidCandidates(candidates)
            if metric not in muvera_fde.FDE_METRICS:
                raise E.InvalidMuveraConfig(
                    "muvera candidate generation requires a dot-family "
                    f"metric, got {metric!r}")
            fde_cfg = muvera_fde.normalize_config(muvera, self.dimensions)
        elif muvera is not None:
            raise E.InvalidMuveraConfig("muvera config requires candidates")
        self.ensure_open()
        if not isinstance(query_sets, (list, tuple)):
            raise E.InvalidMultiVector("invalid multi vector")
        if len(query_sets) == 0:
            return []
        qtok, qmask = self._pad_query_sets(query_sets)
        cache = self._scan_cache()
        if cache.n == 0:
            return [[] for _ in query_sets]
        tokens, counts = cache.multi_vectors()
        valid = cache.valid_mask()
        k = min(limit, cache.n)
        if (fde_cfg is not None and self.mesh is None
                and candidates < cache.n):
            # candidates >= n is the exact scan by definition — fall through
            slots, scores, ok = self._mv_fde_pipeline(
                cache, tokens, counts, qtok, qmask, metric=metric,
                candidates=candidates, cfg=fde_cfg, k=k)
            out = []
            for b in range(len(query_sets)):
                if not bool(ok[b]):
                    out.append(self._multi_vector_host(
                        cache, None, qtok[b][qmask[b]], metric, limit))
                else:
                    out.append(self._mv_slots_to_results(
                        cache, slots[b], scores[b], metric))
            return out
        chunk = _mv_chunk(cache.cap, qtok.shape[0], qtok.shape[1], tokens.shape[1])
        if self.mesh is not None:
            from .parallel import adaptive_mesh as amesh

            qtok_p, B = self._mesh_pad_queries(qtok.reshape(qtok.shape[0], -1))
            qtok_p = qtok_p.reshape(-1, qtok.shape[1], qtok.shape[2])
            qmask_p = np.zeros((qtok_p.shape[0], qmask.shape[1]), bool)
            qmask_p[:B] = qmask
            slots, scores, ok = jax.device_get(amesh.sharded_maxsim_topk(
                self.mesh, tokens, counts, valid,
                jnp.asarray(qtok_p), jnp.asarray(qmask_p),
                metric=metric, limit=k, chunk=chunk,
            ))
        else:
            slots, scores, ok = jax.device_get(maxsim_ops.maxsim_full_topk_batch(
                tokens, counts, valid, jnp.asarray(qtok), jnp.asarray(qmask),
                metric=metric, limit=k, chunk=chunk,
            ))
        out = []
        for b in range(len(query_sets)):
            if not bool(ok[b]):
                out.append(self._multi_vector_host(
                    cache, None, qtok[b][qmask[b]], metric, limit))
            else:
                out.append(self._mv_slots_to_results(cache, slots[b], scores[b], metric))
        return out

    @observed("hybrid_search")
    def hybrid_search(self, query, *, limit=10, generators=None, rerank="exact",
                      **extra) -> list:
        """Candidate-generator union + rerank (collection.ex:337-348,516-658).

        >>> import vettore_tpu as vt
        >>> col = vt.Collection(name="doc-hybrid", dimensions=2,
        ...                     metric="cosine", index="flat")
        >>> col.put_many([{"id": "a", "vector": [1.0, 0.0]},
        ...               {"id": "b", "vector": [0.0, 1.0]}])
        >>> [r.id for r in col.hybrid_search([1.0, 0.2], limit=1,
        ...                                  generators=["funnel", "quantized"])]
        ['a']
        >>> col.close()
        """
        _reject_extra(extra)
        _validate_limit(limit)
        if generators is None:
            generators = self._default_generators()
        if not isinstance(generators, (list, tuple)) or not generators:
            raise E.InvalidGenerator(generators)
        q = self.prepare_query(query)
        if self.mesh is not None:
            # ride the sharded batch pipeline; raw query so normalization is
            # applied exactly once
            rr = rerank
            if (isinstance(rerank, tuple) and len(rerank) in (2, 3)
                    and rerank[0] == "multi_vector"):
                rr = ("multi_vector", [rerank[1]]) + tuple(rerank[2:])
            return self.hybrid_search_batch(
                np.asarray(query, np.float64)[None, :], limit=limit,
                generators=generators, rerank=rr)[0]
        return self._hybrid_single(q, limit, generators, rerank)

    def _default_generators(self) -> list:
        """collection.ex:513-514: hnsw collections default to
        [:hnsw, :quantized], everything else to [:funnel, :quantized]; ivf
        collections (an extension beyond the reference) analogously pair their index
        generator with the quantized prefilter."""
        if self.index_kind == "hnsw":
            return ["hnsw", "quantized"]
        if self.index_kind == "ivf":
            return ["search", "quantized"]
        return ["funnel", "quantized"]

    def _hybrid_single(self, q, limit, generators, rerank) -> list:
        """Host-orchestrated single-query hybrid pipeline (also the overflow
        fallback target for the batch/mesh paths — must not re-enter them)."""
        cache = self._scan_cache()

        candidate_ids: list = []
        seen = set()
        for gen in generators:
            for id in self._run_generator(cache, q, gen, limit):
                if id not in seen:
                    seen.add(id)
                    candidate_ids.append(id)
        return self._hybrid_rerank(cache, q, candidate_ids, rerank, limit)

    def _parse_generator(self, gen, limit):
        """Validates one hybrid generator spec; returns (name, candidates,
        stages) with stages only set for funnel (collection.ex:535-556)."""
        if isinstance(gen, str):
            name, opts = gen, {}
        elif isinstance(gen, tuple) and len(gen) == 2 and isinstance(gen[0], str):
            name, opts = gen[0], dict(gen[1])
        else:
            raise E.InvalidGenerator(gen)
        allowed = {
            "funnel": {"candidates", "stages", "dimensions"},
            "quantized": {"candidates"},
            "search": {"candidates"},
            "hnsw": {"candidates"},
        }.get(name)
        if allowed is None:
            raise E.UnknownGenerator(name)
        for key in opts:
            if key not in allowed:
                raise E.UnsupportedOption(key)
        candidates = opts.get("candidates", max(limit * 10, limit))
        if (
            not isinstance(candidates, int)
            or isinstance(candidates, bool)
            or candidates <= 0
            or candidates > MAX_USIZE
        ):
            raise E.InvalidCandidates(f"invalid candidates: {candidates!r}")
        stages = None
        if name == "funnel":
            stages = self._funnel_stages(opts.get("stages"), opts.get("dimensions"))
        return name, candidates, stages

    @observed("hybrid_search_batch")
    def hybrid_search_batch(self, queries, *, limit=10, generators=None,
                            rerank="exact", **extra) -> list:
        """Batched hybrid pipeline: all generators run as one device dispatch
        per generator over the whole query batch, the candidate union happens
        on device (sort + neighbor-dedup, ops/pipeline.union_candidates), and
        the rerank (exact or MaxSim) is batched. With a ``multi_vector``
        rerank, pass one query token set per query:
        ``("multi_vector", [qset_0, ..., qset_B-1])`` (+ optional opts dict).
        Semantics per query match ``hybrid_search``
        (collection.ex:337-348,516-658); any per-query overflow falls back to
        the single-query host path."""
        _reject_extra(extra)
        _validate_limit(limit)
        if generators is None:
            generators = self._default_generators()
        if not isinstance(generators, (list, tuple)) or not generators:
            raise E.InvalidGenerator(generators)
        parsed = [self._parse_generator(g, limit) for g in generators]

        mv_rerank = None
        if rerank != "exact":
            if not (
                isinstance(rerank, tuple)
                and len(rerank) in (2, 3)
                and rerank[0] == "multi_vector"
            ):
                raise E.InvalidRerank(rerank)
            opts = dict(rerank[2]) if len(rerank) == 3 else {}
            for key in opts:
                if key != "metric":
                    raise E.UnsupportedOption(key)
            mv_metric = normalize_metric(opts.get("metric", self.metric))
            if mv_metric not in METRICS:
                raise E.InvalidMetric(f"invalid metric: {mv_metric!r}")
            mv_rerank = (mv_metric, rerank[1])

        prepared = self._prepare_query_batch(queries)
        B = prepared.shape[0]
        if mv_rerank is not None:
            if not isinstance(mv_rerank[1], (list, tuple)) or len(mv_rerank[1]) != B:
                raise E.InvalidMultiVector(
                    "multi_vector rerank needs one query token set per query"
                )
        cache = self._scan_cache()
        if B == 0:
            return []
        if cache.n == 0:
            return [[] for _ in range(B)]
        amesh = None
        if self.mesh is not None:
            from .parallel import adaptive_mesh as amesh

            prepared, B = self._mesh_pad_queries(prepared)
        qdev = put_f32_matrix(prepared.astype(np.float32, copy=False))
        B_pad = prepared.shape[0]

        blocks = []
        gen_oks = []  # device [B] flags; False -> that query re-runs on host
        for name, candidates, stages in parsed:
            count = min(candidates, cache.n)
            if name == "funnel":
                x, valid = cache.vectors()
                if amesh is not None:
                    slots, slot_ok, g_ok = amesh.sharded_funnel_candidates(
                        self.mesh, x, valid, qdev, metric=self.metric,
                        stages=tuple(stages), count=count,
                    )
                else:
                    slots, slot_ok, g_ok = pipe.funnel_candidates_batch(
                        x, valid, qdev,
                        metric=self.metric, stages=tuple(stages),
                        count=count,
                    )
                blocks.append(jnp.where(slot_ok, slots, _BIG32))
                gen_oks.append(g_ok)
            elif name == "quantized":
                signs = cache.signs()
                valid = cache.valid_mask()
                if amesh is not None:
                    slots, slot_ok, g_ok = amesh.sharded_quantized_candidates(
                        self.mesh, signs, valid, qdev, count=count,
                        d=self.dimensions,
                    )
                else:
                    slots, slot_ok, g_ok = pipe.quantized_candidates_batch(
                        signs, valid, qdev, count=count, d=self.dimensions,
                    )
                blocks.append(jnp.where(slot_ok, slots, _BIG32))
                gen_oks.append(g_ok)
            else:
                if name == "hnsw" and self.index_kind != "hnsw":
                    raise E.HnswIndexRequired("hnsw generator requires an hnsw index")
                cand_dev = getattr(self._index, "candidate_slots_device", None)
                table = None
                if callable(cand_dev):
                    islots, iok = cand_dev(qdev, count)
                    # AFTER the device search (it refreshes the device graph)
                    table = cache.index_slot_table(self._index)
                if table is not None:
                    mapped = jnp.where(
                        iok, table[jnp.clip(islots, 0, table.shape[0] - 1)], _BIG32
                    )
                    blocks.append(mapped)
                else:
                    # custom index without a device path: host per-query scan
                    rows = []
                    for b in range(B):
                        hits = self._index.search(prepared[b], count)
                        rows.append(
                            [cache.slot_of[i] for i, _ in hits if i in cache.slot_of]
                        )
                    width = max([len(r) for r in rows] + [1])
                    arr = np.full((B_pad, width), _BIG32, np.int32)
                    for b, r in enumerate(rows):
                        arr[b, : len(r)] = r
                    blocks.append(jnp.asarray(arr))

        cat = blocks[0] if len(blocks) == 1 else jnp.concatenate(blocks, axis=1)
        u_slots, u_ok = pipe.union_candidates(cat)
        k = min(limit, cache.n)

        if mv_rerank is None:
            x, _valid = cache.vectors()
            if amesh is not None:
                top, raws, ranks, fin = amesh.sharded_subset_rerank(
                    self.mesh, x, u_slots, u_ok, qdev, metric=self.metric,
                    limit=k,
                )
            else:
                top, raws, ranks, fin = pipe.rerank_batch(
                    x, u_slots, u_ok, qdev, metric=self.metric, limit=k,
                )
            top, raws, ranks, fin, *g_ok_host = jax.device_get(
                (top, raws, ranks, fin, *gen_oks))
            out = []
            for b in range(B):
                if not (bool(fin[b]) and all(bool(o[b]) for o in g_ok_host)):
                    out.append(self._hybrid_fallback(queries, b, limit, generators, rerank))
                else:
                    out.append(self._slots_to_results(cache, top[b], raws[b], ranks[b]))
            return out

        mv_metric, qsets = mv_rerank
        qtok, qmask = self._pad_query_sets(qsets)
        if amesh is not None and B_pad != qtok.shape[0]:
            pad = B_pad - qtok.shape[0]
            qtok = np.concatenate(
                [qtok, np.zeros((pad,) + qtok.shape[1:], np.float32)])
            qmask = np.concatenate(
                [qmask, np.zeros((pad, qmask.shape[1]), bool)])
        tokens, counts = cache.multi_vectors()
        # chunk the query batch so the [B, C, T, d] candidate gather stays
        # bounded (~512 MB)
        width = int(u_slots.shape[1])
        t_max = int(tokens.shape[1])
        per_q = max(1, width * t_max * self.dimensions)
        bs = max(1, (512 * 1024 * 1024 // 4) // per_q)
        if amesh is not None:
            data = self.mesh.shape["data"]
            bs = max(data, bs - bs % data)
        tops, scores_l, oks = [], [], []
        for s in range(0, B_pad, bs):
            if amesh is not None:
                t, sc, o = amesh.sharded_subset_maxsim(
                    self.mesh, tokens, counts, u_slots[s : s + bs],
                    u_ok[s : s + bs], jnp.asarray(qtok[s : s + bs]),
                    jnp.asarray(qmask[s : s + bs]), metric=mv_metric, limit=k,
                )
            else:
                t, sc, o = maxsim_ops.maxsim_subset_topk_batch(
                    tokens, counts, u_slots[s : s + bs], u_ok[s : s + bs],
                    jnp.asarray(qtok[s : s + bs]), jnp.asarray(qmask[s : s + bs]),
                    metric=mv_metric, limit=k,
                )
            tops.append(t)
            scores_l.append(sc)
            oks.append(o)
        top = jnp.concatenate(tops)
        scores = jnp.concatenate(scores_l)
        mv_ok = jnp.concatenate(oks)
        top, scores, mv_ok, *g_ok_host = jax.device_get((top, scores, mv_ok, *gen_oks))
        out = []
        for b in range(B):
            if not (bool(mv_ok[b]) and all(bool(o[b]) for o in g_ok_host)):
                single_rerank = (
                    ("multi_vector", qsets[b])
                    if len(rerank) == 2
                    else ("multi_vector", qsets[b], rerank[2])
                )
                out.append(self._hybrid_fallback(queries, b, limit, generators,
                                                 single_rerank))
            else:
                out.append(self._mv_slots_to_results(cache, top[b], scores[b], mv_metric))
        return out

    def _hybrid_fallback(self, queries, b, limit, generators, rerank):
        """Single-query host re-run for a batch element whose device pipeline
        overflowed (f64-recovery posture, distances.rs:59-98)."""
        q = self.prepare_query(np.asarray(queries, dtype=np.float64)[b])
        return self._hybrid_single(q, limit, generators, rerank)

    def _run_generator(self, cache, q, gen, limit) -> list:
        name, candidates, stages = self._parse_generator(gen, limit)

        if name == "funnel":
            if cache.n == 0:
                return []
            x, valid = cache.vectors()
            count = min(candidates, cache.n)
            slots, ok, finite = pipe.funnel_candidates_pipeline(
                x, valid, jnp.asarray(q),
                metric=self.metric, stages=tuple(stages), count=count,
            )
            slots, ok, finite = jax.device_get((slots, ok, finite))
            if not bool(finite):
                pairs = [(r.id, np.asarray(r.vector)) for r in cache.records]
                for dims in stages:
                    hits = scan_host.vector_top_k(pairs, q, self.metric, dims, candidates)
                    by_id = {id: v for id, v in pairs}
                    pairs = [(id, by_id[id]) for id, _ in hits]
                return [id for id, _ in pairs] if stages else []
            return [cache.ids[int(s)] for s, o in zip(slots, ok) if o]
        if name == "quantized":
            if cache.n == 0:
                return []
            signs = cache.signs()
            _x, valid = cache.vectors()
            count = min(candidates, cache.n)
            slots, ok, sel_ok = jax.device_get(
                pipe.quantized_candidates_pipeline(
                    signs, valid, jnp.asarray(q), count=count, d=self.dimensions
                )
            )
            if not bool(sel_ok):
                # tie spill past the selection slack: exact host candidates
                qwords = [int(w) for w in pack_signs_u64_rows(q[None, :])[0]]
                pairs = []
                for r in cache.records:
                    words = (
                        [int(w) for w in r.binary_vector]
                        if r.binary_vector is not None
                        else [int(w) for w in pack_signs_u64_rows(
                            np.asarray(r.vector, np.float64)[None, :])[0]]
                    )
                    pairs.append((r.id, words))
                hits = scan_host.binary_top_k(pairs, qwords, self.dimensions, candidates)
                return [id for id, _ in hits]
            return [cache.ids[int(s)] for s, o in zip(slots, ok) if o]
        if name == "hnsw" and self.index_kind != "hnsw":
            raise E.HnswIndexRequired("hnsw generator requires an hnsw index")
        # "search" / "hnsw": go through the collection index
        hits = self._index.search(q, candidates)
        return [id for id, _ in hits if id in cache.slot_of]

    def _hybrid_rerank(self, cache, q, candidate_ids, rerank, limit):
        if rerank == "exact":
            if not candidate_ids:
                return []
            # ascending slots ARE lex order (the cache is id-sorted), which
            # the stable-topk tie-break requires
            slots = np.array(sorted(cache.slot_of[id] for id in candidate_ids), dtype=np.int32)
            bucket = _pow2_at_least(len(slots), 1)
            ok = np.zeros(bucket, dtype=bool)
            ok[: len(slots)] = True
            padded = np.zeros(bucket, dtype=np.int32)
            padded[: len(slots)] = slots
            x, _valid = cache.vectors()
            k = min(limit, len(slots))
            top, raws, ranks, finite = jax.device_get(
                pipe.rerank_pipeline(
                    x, jnp.asarray(padded), jnp.asarray(ok), jnp.asarray(q),
                    metric=self.metric, limit=k,
                )
            )
            if not bool(finite):
                pairs = [(id, np.asarray(cache.by_id[id].vector)) for id in candidate_ids]
                hits = scan_host.vector_top_k(pairs, q, self.metric, self.dimensions, limit)
                return [self._to_result(cache.by_id[id], raw) for id, raw in hits]
            return self._slots_to_results(cache, top, raws, ranks)

        if (
            isinstance(rerank, tuple)
            and len(rerank) in (2, 3)
            and rerank[0] == "multi_vector"
        ):
            query_vectors = rerank[1]
            opts = dict(rerank[2]) if len(rerank) == 3 else {}
            for key in opts:
                if key != "metric":
                    raise E.UnsupportedOption(key)
            metric = normalize_metric(opts.get("metric", self.metric))
            if metric not in METRICS:
                raise E.InvalidMetric(f"invalid metric: {metric!r}")
            queries = self._prepare_query_vectors(query_vectors)
            if not candidate_ids:
                return []
            tokens, counts = cache.multi_vectors()
            # ascending slots ARE lex order (id-sorted cache)
            slots = np.array(sorted(cache.slot_of[id] for id in candidate_ids), dtype=np.int32)
            bucket = _pow2_at_least(len(slots), 1)
            ok = np.zeros(bucket, dtype=bool)
            ok[: len(slots)] = True
            padded = np.zeros(bucket, dtype=np.int32)
            padded[: len(slots)] = slots
            k = min(limit, len(slots))
            top, scores, dev_ok = jax.device_get(
                _mv_subset_pipeline(
                    tokens, counts, jnp.asarray(padded), jnp.asarray(ok),
                    jnp.asarray(queries), metric=metric, limit=k,
                )
            )
            if not bool(dev_ok):
                documents = []
                for id in candidate_ids:
                    r = cache.by_id[id]
                    vs = r.vectors if _has_tokens(r.vectors) else [r.vector]
                    documents.append((id, [list(np.asarray(v, np.float64)) for v in vs]))
                hits = maxsim_ops.top_k(documents, [list(qv) for qv in queries], metric, limit)
                return [
                    Result(id=id, value=cache.by_id[id].value, score=score, distance=None,
                           metric=metric, metadata=cache.by_id[id].metadata)
                    for id, score in hits
                ]
            results = []
            for slot, score in zip(top, scores):
                if not np.isfinite(score):
                    continue
                r = cache.records[int(slot)]
                results.append(
                    Result(id=r.id, value=r.value, score=float(score), distance=None,
                           metric=metric, metadata=r.metadata)
                )
            return results

        raise E.InvalidRerank(rerank)

    def _slots_to_results(self, cache, slots, raws, ranks) -> list:
        results = []
        for slot, raw, rank in zip(slots, raws, ranks):
            if not np.isfinite(rank):
                continue
            results.append(self._to_result(cache.records[int(slot)], float(raw)))
        return results

    # ------------------------------------------------------------------
    # snapshot / restore (collection.ex:135-164,376-433)
    # ------------------------------------------------------------------

    def snapshot(self, path: str) -> None:
        """Atomic checksummed snapshot (tmp write + rename, store/ets.ex:29-45).

        >>> import tempfile, os
        >>> import vettore_tpu as vt
        >>> col = vt.Collection(name="doc-snap", dimensions=2, index="flat")
        >>> col.put({"id": "a", "vector": [1.0, 0.0]})
        >>> d = tempfile.mkdtemp()
        >>> col.snapshot(os.path.join(d, "c.vsnap"))
        >>> loaded = vt.load_snapshot(os.path.join(d, "c.vsnap"))
        >>> [r.id for r in loaded.search([1.0, 0.0], limit=1)]
        ['a']
        >>> loaded.close(); col.close()
        """
        if not isinstance(path, str):
            raise E.InvalidSnapshot("invalid snapshot path")
        self.ensure_open()
        configure = getattr(self._store, "configure", None)
        if callable(configure):
            configure(self._config())
        self._store.snapshot(path)


def load_snapshot(path: str, *, name=None, index=None, index_options=None, score=None,
                  store=None, mesh=None, **extra):
    """Loads a collection from a snapshot; the index is rebuilt from canonical
    records, never deserialized. Overrides are restricted to non-structural
    fields (collection.ex:54,1159-1174) and persist through later snapshots.
    Passing ``mesh`` rebuilds the index sharded across the mesh — the
    snapshot format is identical either way (host records are canonical)."""
    for key in extra:
        raise E.UnsupportedSnapshotOverride(key)
    if not isinstance(path, str):
        raise E.InvalidSnapshot("invalid snapshot path")
    if store == "columnar":
        # ColumnarStore.load_snapshot picks bf16 itself for compressed configs
        from .store.columnar import ColumnarStore

        store = ColumnarStore
    store_cls = MemoryStore if store is None else store
    if not (isinstance(store_cls, type) and callable(getattr(store_cls, "load_snapshot", None))):
        raise E.InvalidStore(f"invalid store: {store!r}")
    loaded_store, config = store_cls.load_snapshot(path)
    try:
        return _restore(loaded_store, config, name=name, index=index,
                        index_options=index_options, score=score, mesh=mesh)
    except Exception:
        close = getattr(loaded_store, "close", None)
        if callable(close):
            close()
        raise


def _restore(loaded_store, config, *, name, index, index_options, score, mesh=None):
    if not isinstance(config, dict):
        raise E.InvalidSnapshot("snapshot config must be a map")
    if config.get("snapshot_version", 0) not in (0, SNAPSHOT_VERSION):
        raise E.UnsupportedSnapshotVersion("unsupported snapshot version")

    collection = Collection.__new__(Collection)
    metric = normalize_metric(config.get("metric", "cosine"))
    dimensions = config.get("dimensions")
    normalize = config.get("normalize", default_normalize(metric))
    index_kind = index if index is not None else config.get("index", "flat")
    opts = index_options if index_options is not None else config.get("index_options", {}) or {}
    score_mode = score if score is not None else config.get("score", "raw")
    compressed = config.get("compressed", False)

    if not isinstance(dimensions, int) or isinstance(dimensions, bool) or dimensions <= 0:
        raise E.InvalidDimensions(f"invalid dimensions: {dimensions!r}")
    if metric not in METRICS:
        raise E.InvalidMetric(f"invalid metric: {metric!r}")
    if normalize not in NORMALIZATIONS:
        raise E.InvalidNormalization(f"invalid normalization: {normalize!r}")
    if score_mode not in _SCORE_MODES:
        raise E.InvalidScoreMode(f"invalid score mode: {score_mode!r}")
    if not isinstance(compressed, bool):
        raise E.VettoreError("compressed must be a boolean", reason="invalid_compressed")
    if not isinstance(opts, dict):
        raise E.InvalidIndexOptions("index_options must be a dict")

    collection.name = name if name is not None else config.get("name")
    collection.dimensions = dimensions
    collection.metric = metric
    collection.normalize = normalize
    collection.score = score_mode
    collection.index_kind = index_kind if isinstance(index_kind, str) else "custom"
    collection.index_options = dict(opts)
    collection.compressed = compressed
    collection.mesh = mesh
    collection._stats = StatsRegistry()
    collection._index = Collection._make_index(index_kind, metric, dict(opts), compressed,
                                               mesh=mesh)
    collection._store = loaded_store
    collection._write_lock = threading.RLock()
    collection._version = 0
    collection._cache = None
    collection._cache_version = -1

    records = loaded_store.all()
    _validate_snapshot_records(collection, records)
    records = sorted(records, key=lambda r: r.id)
    # million-row restore: one stacked matrix through the index's bulk path
    # (a per-pair put_many loop costs minutes at 1M; the canonical-store
    # rebuild must stay O(n) numpy — same posture as put_matrix)
    index_bulk = getattr(collection._index, "put_matrix", None)
    mat = None
    if callable(index_bulk) and records and all(
        isinstance(r.vector, np.ndarray) and r.vector.shape == (dimensions,)
        for r in records
    ):
        mat = np.concatenate(
            [r.vector for r in records], dtype=np.float32
        ).reshape(len(records), dimensions)
    if mat is not None:
        index_bulk([r.id for r in records], mat)
    else:
        collection._index.put_many([(r.id, r.vector) for r in records])
    configure = getattr(loaded_store, "configure", None)
    if callable(configure):
        configure(collection._config())
    return collection


def _validate_snapshot_records(collection, records):
    if not isinstance(records, list):
        raise E.InvalidSnapshot("invalid snapshot records")
    d = collection.dimensions
    W = words_for(d)
    # vectorized fast path for what the snapshot reader actually produces
    # (homogeneous f32 ndarray rows, uint64 word rows): one bulk finite
    # check instead of a million per-record validations. Anything unusual
    # falls through to the per-record loop for the precise error.
    if records and all(
        isinstance(r, Embedding)
        and ((isinstance(r.id, str) and r.id)
             or (isinstance(r.value, str) and r.value))
        and isinstance(r.vector, np.ndarray)
        and r.vector.shape == (d,)
        and r.vector.dtype == np.float32
        and r.vectors is None
        and (r.binary_vector is None or (
            isinstance(r.binary_vector, np.ndarray)
            and r.binary_vector.dtype == np.uint64
            and r.binary_vector.shape == (W,)))
        for r in records
    ):
        block = np.concatenate([r.vector for r in records]).reshape(-1, d)
        if np.isfinite(block).all():
            return
    for r in records:
        if not isinstance(r, Embedding):
            raise E.InvalidSnapshotRecord("invalid_embedding")
        try:
            if not (isinstance(r.id, str) and r.id) and not (
                isinstance(r.value, str) and r.value
            ):
                raise E.MissingId("missing id")
            collection._validate_dims(r.vector)
            if r.vectors is not None:
                if (
                    not isinstance(r.vectors, (list, tuple, np.ndarray))
                    or len(r.vectors) == 0
                ):
                    raise E.InvalidMultiVector("invalid multi vector")
                for v in r.vectors:
                    collection._validate_dims(v)
            if r.binary_vector is not None:
                words = [int(w) for w in r.binary_vector]
                if len(words) != words_for(collection.dimensions) or any(
                    w < 0 or w > 2**64 - 1 for w in words
                ):
                    raise E.InvalidBinaryVector("invalid binary vector")
        except E.VettoreError as exc:
            raise E.InvalidSnapshotRecord(exc.reason) from exc
