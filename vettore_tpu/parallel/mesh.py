"""Mesh-sharded flat search: row shards, query broadcast, top-k merge.

The reference is single-node (SURVEY §2.3): ETS is the only shared state and
reads scale via concurrent reader processes. The device equivalent scales
two ways on a 2-D device mesh:

* ``data`` axis — query batches are data-parallel (the analog of BEAM's
  concurrent readers);
* ``shard`` axis — the ``[N, d]`` embedding block is row-sharded across
  devices. Each device computes a local top-k over its rows, then the
  k-candidate sets (rank, lex-rank, global slot) cross the interconnect
  through ``all_gather`` and merge with
  a multi-key sort, preserving the reference's deterministic (rank, id)
  tie-break end-to-end.

Works identically on a virtual CPU mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``) and real devices.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.distance import batched_raw_scores, rank_from_raw


def make_mesh(devices=None, *, data: int = 1) -> Mesh:
    """Builds a ``(data, shard)`` mesh over the given (or all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % data != 0:
        raise ValueError(f"{n} devices not divisible by data={data}")
    arr = np.array(devices).reshape(data, n // data)
    return Mesh(arr, ("data", "shard"))


def _local_topk(x_block, valid_block, lex_block, q, *, metric, k):
    """Per-shard exact top-k with (rank, lex) multi-key sort; returns
    fixed-size candidate triples (rank, lex, local_row)."""
    raw = batched_raw_scores(x_block, q, metric=metric)
    rank = rank_from_raw(raw, metric=metric)
    rank = jnp.where(valid_block, rank, jnp.inf)
    rows = jnp.arange(x_block.shape[0], dtype=jnp.int32)
    r, l, s, rw = jax.lax.sort((rank, lex_block, rows, raw), num_keys=2)
    return r[:k], l[:k], s[:k], rw[:k]


def program_cache(builder):
    """Memoizes JITTED shard_map programs by their static key.

    Building the shard_map inside the search wrapper re-traces AND re-lowers
    the whole sharded program on EVERY batch, which costs far more than the
    search itself.
    ``builder(*key)`` returns the traced step fn; the cache holds one jitted
    callable per (mesh, statics...) key, and jit's own cache handles shapes.
    """
    cache = {}

    @functools.wraps(builder)
    def get(*key):
        fn = cache.get(key)
        if fn is None:
            fn = cache[key] = jax.jit(builder(*key))
        return fn

    return get


@program_cache
def _search_program(mesh, metric, k, shard_size):
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("shard", None), P("shard"), P("shard"), P("data", None)),
        out_specs=(P("data", None), P("data", None)),
        # outputs are replicated over 'shard' by the all_gather+sort merge;
        # that replication can't be statically inferred, so varying-mode
        # checking is disabled for this program
        check_vma=False,
    )
    def step(x_block, valid_block, lex_block, q_block):
        shard_idx = jax.lax.axis_index("shard")
        offset = shard_idx * shard_size

        def one(q):
            r, l, s, rw = _local_topk(x_block, valid_block, lex_block, q, metric=metric, k=k)
            return r, l, s + offset, rw

        r, l, s, rw = jax.vmap(one)(q_block)  # [b, k] each
        # gather candidate sets from every shard and merge
        r = jax.lax.all_gather(r, "shard", axis=1, tiled=True)  # [b, S*k]
        l = jax.lax.all_gather(l, "shard", axis=1, tiled=True)
        s = jax.lax.all_gather(s, "shard", axis=1, tiled=True)
        rw = jax.lax.all_gather(rw, "shard", axis=1, tiled=True)
        rm, _, sm, rwm = jax.lax.sort((r, l, s, rw), num_keys=2, dimension=1)
        top_s = jnp.where(jnp.isfinite(rm[:, :k]), sm[:, :k], -1)
        return top_s, rwm[:, :k]

    return step


def sharded_search(mesh: Mesh, x, valid, lex_rank, queries, *, metric: str, k: int):
    """Sharded exact search over a row-sharded block.

    ``x`` [N, d], ``valid`` [N], ``lex_rank`` [N] (global id-order rank per
    row) are sharded over ``shard``; ``queries`` [B, d] over ``data``.
    Returns ``(slots [B, k] int32 global row indices, raws [B, k])``, invalid
    positions marked with slot -1.
    """
    shard_size = x.shape[0] // mesh.shape["shard"]
    return _search_program(mesh, metric, k, shard_size)(x, valid, lex_rank, queries)


class ShardedFlat:
    """A flat exact index sharded across a device mesh.

    Rows pad up to a multiple of the shard count; the host keeps ids and the
    id→row map (canonical data stays host-side and rebuildable, as in the
    single-chip design).
    """

    def __init__(self, metric: str, mesh: Mesh, ids, vectors, *, storage: str = "f32"):
        self.metric = metric
        self.mesh = mesh
        self.storage = storage
        shards = mesh.shape["shard"]
        vectors = np.asarray(vectors, dtype=np.float32)
        n, d = vectors.shape
        if len(ids) != n:
            raise ValueError("ids/vectors length mismatch")
        cap = max(shards, math.ceil(n / shards) * shards)
        x = np.zeros((cap, d), dtype=np.float32)
        x[:n] = vectors
        if storage == "bf16":
            # half the at-rest HBM per shard; scoring upcasts to f32
            import ml_dtypes

            x = x.astype(ml_dtypes.bfloat16)
        valid = np.zeros(cap, dtype=bool)
        valid[:n] = True
        order = np.argsort(np.array(ids, dtype=str), kind="stable")
        lex_rank = np.zeros(cap, dtype=np.int32)
        lex_rank[order] = np.arange(n, dtype=np.int32)
        lex_rank[n:] = np.iinfo(np.int32).max
        self.ids = list(ids)
        self.n = n
        self._slot_of = {str(id): i for i, id in enumerate(ids)}
        self._valid_host = valid
        row_sharding = NamedSharding(mesh, P("shard", None))
        self._flag_sharding = NamedSharding(mesh, P("shard"))
        self._x = jax.device_put(x, row_sharding)
        self._valid = jax.device_put(valid, self._flag_sharding)
        self._lex = jax.device_put(lex_rank, self._flag_sharding)

    def invalidate_ids(self, ids) -> None:
        """Masks rows out of the search (delete without resharding: one
        [cap]-bool transfer; the canonical host store is unaffected)."""
        changed = False
        for id in ids:
            slot = self._slot_of.get(str(id))
            if slot is not None and self._valid_host[slot]:
                self._valid_host[slot] = False
                changed = True
        if changed:
            self._valid = jax.device_put(self._valid_host, self._flag_sharding)

    def search_batch(self, queries, limit: int) -> list:
        """Returns ``[(id, raw)]`` per query, merged across shards."""
        queries = np.asarray(queries, dtype=np.float32)
        b = queries.shape[0]
        dp = self.mesh.shape["data"]
        pad_b = max(dp, math.ceil(b / dp) * dp)
        padded = np.zeros((pad_b, queries.shape[1]), dtype=np.float32)
        padded[:b] = queries
        q = jax.device_put(padded, NamedSharding(self.mesh, P("data", None)))
        k = min(limit, max(self.n, 1))
        slots, raws = jax.device_get(
            sharded_search(self.mesh, self._x, self._valid, self._lex, q,
                           metric=self.metric, k=k)
        )
        out = []
        for row in range(b):
            hits = []
            for slot, raw in zip(slots[row], raws[row]):
                if slot < 0 or slot >= self.n:
                    continue
                hits.append((self.ids[int(slot)], float(raw)))
            out.append(hits[:limit])
        return out
