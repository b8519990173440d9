"""Mesh-sharded HNSW: one sub-graph per chip, scatter-gather search over the interconnect.

Collections past one chip's HBM shard by rows: each shard builds an
independent HNSW graph over its rows (device wave construction), and a query
searches every shard's graph in parallel under ``shard_map``, then the
per-shard top-k candidate sets (rank, lex-rank, global row) merge over the interconnect
with a multi-key sort — identical ordering semantics to single-chip search.

Searching S smaller graphs with the same ef does not lose recall relative to
one big graph (each shard's exact neighbors are a superset of the global
top-k restricted to that shard); the merge is exact over the candidates.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index import hnsw_build, hnsw_device
from ..index.hnsw import validate_options
from ..metrics import normalize_metric
from .mesh import program_cache


class ShardedHnsw:
    """HNSW index sharded across the ``shard`` axis of a device mesh."""

    def __init__(self, metric: str, mesh: Mesh, ids, vectors, *, options=None):
        metric = normalize_metric(metric)
        self.metric = metric
        self.params = validate_options(options)
        self.mesh = mesh
        shards = mesh.shape["shard"]
        vectors = np.asarray(vectors, dtype=np.float32)
        n, d = vectors.shape
        if len(ids) != n:
            raise ValueError("ids/vectors length mismatch")
        per = math.ceil(n / shards)

        # global lex ranks for the deterministic merge tie-break
        order = np.argsort(np.array([str(i) for i in ids], dtype=str), kind="stable")
        global_lex = np.zeros(n, dtype=np.int32)
        global_lex[order] = np.arange(n, dtype=np.int32)

        graphs = []
        row_of = []  # per shard: local slot -> global row
        for s in range(shards):
            lo, hi = s * per, min((s + 1) * per, n)
            shard_ids = [str(ids[i]) for i in range(lo, hi)]
            if not shard_ids:
                shard_ids, shard_vecs = ["__pad__"], np.zeros((1, d), np.float32)
            else:
                shard_vecs = vectors[lo:hi]
            graph = hnsw_build.bulk_build(self.metric, self.params, shard_ids, shard_vecs)
            graphs.append(graph)
            id_to_row = {str(ids[i]): i for i in range(lo, hi)}
            row_of.append(np.array(
                [id_to_row.get(gid, -1) for gid in graph.ids], dtype=np.int32
            ))

        # pad all shard graphs to common static shapes and stack on axis 0
        cap = max(g.n for g in graphs)
        cap_up = max(max(np.asarray(g.up_adj).shape[0], 1) for g in graphs)
        lmax = max(g.lmax for g in graphs)
        m = self.params["m"]
        m0 = self.params["m0"]
        xs = np.zeros((shards, cap, d), np.float32)
        a0s = np.full((shards, cap, m0), -1, np.int32)
        upis = np.full((shards, cap), -1, np.int32)
        upas = np.full((shards, cap_up, max(lmax, 1), m), -1, np.int32)
        lexs = np.full((shards, cap), 2**30, np.int32)
        rows = np.full((shards, cap), -1, np.int32)
        entries = np.zeros((shards, 2), np.int32)
        for s, g in enumerate(graphs):
            xs[s, : g.n] = np.asarray(g.x)
            a0s[s, : g.n] = np.asarray(g.a0)
            upis[s, : g.n] = np.asarray(g.up_index)
            ua = np.asarray(g.up_adj)
            upas[s, : ua.shape[0], : ua.shape[1]] = ua
            # per-shard lex must use GLOBAL lex ranks so the merge tie-break
            # is identical to a single-chip index
            valid_rows = row_of[s]
            shard_lex = np.where(valid_rows >= 0, global_lex[np.maximum(valid_rows, 0)], 2**30)
            lexs[s, : g.n] = shard_lex
            rows[s, : g.n] = valid_rows
            entries[s] = (int(g.entry_slot), int(g.entry_level))

        self.ids = [str(i) for i in ids]
        self.n = n
        self.d = d
        self.lmax = lmax
        self._graphs = graphs
        self._row_of = [r.copy() for r in row_of]
        self._entries_np = entries
        self._mut = None  # _MeshMut once incrementally mutated
        shard_rows = NamedSharding(mesh, P("shard"))
        self._x = jax.device_put(xs, NamedSharding(mesh, P("shard", None, None)))
        self._a0 = jax.device_put(a0s, NamedSharding(mesh, P("shard", None, None)))
        self._upi = jax.device_put(upis, NamedSharding(mesh, P("shard", None)))
        self._upa = jax.device_put(upas, NamedSharding(mesh, P("shard", None, None, None)))
        self._lex = jax.device_put(lexs, NamedSharding(mesh, P("shard", None)))
        self._rows = jax.device_put(rows, NamedSharding(mesh, P("shard", None)))
        self._entries = jax.device_put(entries, shard_rows)

    @property
    def live(self) -> int:
        """Number of live (searchable) records across every shard."""
        return sum(self._live_counts())

    def _live_counts(self) -> list:
        return [int((r >= 0).sum()) for r in self._row_of]

    def search_batch(self, queries, limit: int) -> list:
        """Returns ``[(id, raw)]`` per query, exact merge across shard graphs."""
        queries = np.asarray(queries, dtype=np.float32)
        b = queries.shape[0]
        dp = self.mesh.shape["data"]
        pad_b = max(dp, math.ceil(b / dp) * dp)
        padded = np.zeros((pad_b, self.d), np.float32)
        padded[:b] = queries
        q = jax.device_put(padded, NamedSharding(self.mesh, P("data", None)))
        live = self.live if self._mut is not None else self.n
        ef = min(max(self.params["ef_search"], limit), max(live, 1))
        k = min(limit, max(live, 1))
        rows, raws = jax.device_get(
            _sharded_search(
                self.mesh, self._x, self._a0, self._upi, self._upa, self._lex,
                self._rows, self._entries, q,
                metric=self.metric, lmax=self.lmax, ef=ef, k=k,
            )
        )
        out = []
        for row in range(b):
            hits = []
            for gr, raw in zip(rows[row], raws[row]):
                if gr < 0:
                    continue
                hits.append((self.ids[int(gr)], float(raw)))
            out.append(hits[:limit])
        return out

    # ------------------------------------------------------------------
    # incremental mutation (per-shard graph puts/deletes, no full rebuild)
    # ------------------------------------------------------------------
    #
    # The reference mutates its single graph in place (hnsw.rs:152-289).
    # The mesh equivalent routes each new record to the least-loaded shard,
    # links it through that shard's incremental wave kernel
    # (hnsw_build.incremental_put), and re-syncs only that shard's slice of
    # the stacked search arrays — a device-side copy, not a minutes-long
    # graph reconstruction. Deletes tombstone (validity-bit flips) exactly
    # like the single-chip path; a shard whose tombstones outgrow
    # hnsw_build.REBUILD_FRACTION compacts alone.
    #
    # The cross-shard (rank, id) merge needs one GLOBAL lex-rank space:
    # per-graph local ranks are not comparable across shards, so the mesh
    # owns a spaced global rank table (same midpoint-insert + respace
    # scheme as hnsw_build._assign_lex) and scatters it into the stacked
    # ``_lex`` plane, independent of each graph's internal ranks.

    def incremental_put(self, ids, vecs) -> None:
        """Insert/replace a batch across the shard graphs in place."""
        ids = [str(i) for i in ids]
        vecs = np.ascontiguousarray(np.asarray(vecs, np.float32))
        last = {}
        for i, id in enumerate(ids):
            last[id] = i
        keep = sorted(last.values())
        ids = [ids[i] for i in keep]
        vecs = vecs[keep]
        if not ids:
            return
        mut = self._ensure_mesh_mutable()
        ranks, respaced = self._assign_global_lex(ids)

        counts = self._live_counts()
        per_shard: dict = {}
        for i, id in enumerate(ids):
            s = mut.shard_of.get(id)
            if s is None:  # new id -> least-loaded shard (replaces stay put)
                s = int(np.argmin(counts))
                counts[s] += 1
            per_shard.setdefault(s, []).append(i)

        for s, idxs in sorted(per_shard.items()):
            g = self._graphs[s]
            st = hnsw_build._ensure_mutable(g)
            sub_ids = [ids[i] for i in idxs]
            old_slots = [st.slot_of[i] for i in sub_ids if i in st.slot_of]
            hnsw_build.incremental_put(g, self.params, sub_ids, vecs[idxs])
            self._grow_shard_maps(s)
            row_of, glex = self._row_of[s], mut.slot_glex[s]
            for old in old_slots:  # replaced vectors vacated their old slot
                row_of[old] = -1
                glex[old] = _BIG_LEX
            for i in idxs:
                id = ids[i]
                slot = st.slot_of[id]
                row = mut.row_by_id.get(id)
                if row is None:
                    self.ids.append(id)
                    row = len(self.ids) - 1
                    mut.row_by_id[id] = row
                mut.shard_of[id] = s
                row_of[slot] = row
                glex[slot] = ranks[i]
            if hnsw_build.should_compact(g):
                self._compact_shard(s)
            else:
                self._refresh_shard(s)
        if respaced:
            self._rescatter_lex()

    def incremental_delete(self, ids) -> int:
        """Tombstones ids out of their shard graphs; returns count removed."""
        mut = self._ensure_mesh_mutable()
        per_shard: dict = {}
        for id in {str(i) for i in ids}:
            s = mut.shard_of.get(id)
            if s is not None:
                per_shard.setdefault(s, []).append(id)
        removed = 0
        for s, sub in sorted(per_shard.items()):
            g = self._graphs[s]
            st = hnsw_build._ensure_mutable(g)
            slots = np.asarray(
                [st.slot_of[i] for i in sub if i in st.slot_of], np.int32)
            removed += hnsw_build.incremental_delete(g, sub)
            self._row_of[s][slots] = -1
            mut.slot_glex[s][slots] = _BIG_LEX
            for id in sub:
                mut.shard_of.pop(id, None)
            if hnsw_build.should_compact(g):
                self._compact_shard(s)
            else:  # validity + entry re-election only — cheap scatters
                sl = jnp.asarray(slots)
                self._rows = self._dput(
                    self._rows.at[s, sl].set(-1), P("shard", None))
                self._lex = self._dput(
                    self._lex.at[s, sl].set(_BIG_LEX), P("shard", None))
                self._sync_entry(s)
        return removed

    # ---- internals ----------------------------------------------------

    def _dput(self, arr, spec):
        return jax.device_put(arr, NamedSharding(self.mesh, spec))

    def _ensure_mesh_mutable(self):
        if self._mut is not None:
            return self._mut
        mut = _MeshMut()
        mut.row_by_id = {}
        mut.shard_of = {}
        for s, row_of in enumerate(self._row_of):
            for slot, row in enumerate(row_of):
                if row >= 0:
                    id = self.ids[int(row)]
                    mut.row_by_id[id] = int(row)
                    mut.shard_of[id] = s
        live_ids = np.sort(np.array(list(mut.shard_of), dtype=str))
        mut.spacing = max(1, min(1024, (_BIG_LEX - 2) // max(len(live_ids), 1)))
        mut.sorted_ids = live_ids
        mut.sorted_ranks = np.arange(len(live_ids), dtype=np.int64) * mut.spacing
        mut.slot_glex = []
        for s, row_of in enumerate(self._row_of):
            glex = np.full(len(row_of), _BIG_LEX, np.int64)
            liv = np.flatnonzero(row_of >= 0)
            if len(liv):
                ids_s = np.array([self.ids[int(r)] for r in row_of[liv]],
                                 dtype=str)
                glex[liv] = mut.sorted_ranks[
                    np.searchsorted(mut.sorted_ids, ids_s)]
            mut.slot_glex.append(glex)
        self._mut = mut
        self._rescatter_lex()  # dense build ranks -> spaced global ranks
        return mut

    def _assign_global_lex(self, ids):
        """Global (rank, id) ranks for a put batch: existing ids keep their
        rank, new ids bisect their lex gap; an exhausted gap (or a rank
        nearing the pad sentinel) respaces the whole table. Returns
        (int64 [B], respaced)."""
        mut = self._mut
        ids_np = np.array(ids, dtype=str)
        ns = len(mut.sorted_ids)
        pos = np.searchsorted(mut.sorted_ids, ids_np)
        exists = np.zeros(len(ids), bool)
        if ns:
            exists = (pos < ns) & (
                mut.sorted_ids[np.minimum(pos, ns - 1)] == ids_np)
        out = np.zeros(len(ids), np.int64)
        out[exists] = mut.sorted_ranks[pos[exists]] if ns else 0
        fresh = np.flatnonzero(~exists)
        if not len(fresh):
            return out, False
        order = fresh[np.argsort(ids_np[fresh], kind="stable")]
        gap_pos = pos[order]
        insert_ids = ids_np[order]
        new_ranks = np.zeros(len(order), np.int64)
        respace = False
        i = 0
        while i < len(order):
            j = i
            while j < len(order) and gap_pos[j] == gap_pos[i]:
                j += 1
            k = j - i
            left = (mut.sorted_ranks[gap_pos[i] - 1] if gap_pos[i] > 0
                    else -(mut.spacing * (k + 1)))
            right = (mut.sorted_ranks[gap_pos[i]] if gap_pos[i] < ns
                     else left + mut.spacing * (k + 1))
            if right - left <= k or right >= _BIG_LEX - 1:
                respace = True
                break
            step = (right - left) / (k + 1)
            new_ranks[i:j] = left + (np.arange(1, k + 1) * step).astype(np.int64)
            i = j
        if insert_ids.dtype.itemsize > mut.sorted_ids.dtype.itemsize:
            mut.sorted_ids = mut.sorted_ids.astype(insert_ids.dtype)
        mut.sorted_ids = np.insert(mut.sorted_ids, gap_pos, insert_ids)
        mut.sorted_ranks = np.insert(mut.sorted_ranks, gap_pos, new_ranks)
        if respace:
            mut.spacing = max(1, min(1024, (_BIG_LEX - 2) // max(
                len(mut.sorted_ids), 1)))
            mut.sorted_ranks = np.arange(
                len(mut.sorted_ids), dtype=np.int64) * mut.spacing
            for s, glex in enumerate(mut.slot_glex):
                liv = np.flatnonzero(self._row_of[s] >= 0)
                if len(liv):
                    ids_s = np.array(
                        [self.ids[int(r)] for r in self._row_of[s][liv]],
                        dtype=str)
                    glex[liv] = mut.sorted_ranks[
                        np.searchsorted(mut.sorted_ids, ids_s)]
            allpos = np.searchsorted(mut.sorted_ids, ids_np)
            return mut.sorted_ranks[allpos], True
        out[order] = new_ranks
        return out, False

    def _grow_shard_maps(self, s) -> None:
        g = self._graphs[s]
        cap = g.x.shape[0]
        if len(self._row_of[s]) < cap:
            pad = cap - len(self._row_of[s])
            self._row_of[s] = np.concatenate(
                [self._row_of[s], np.full(pad, -1, np.int32)])
            self._mut.slot_glex[s] = np.concatenate(
                [self._mut.slot_glex[s], np.full(pad, _BIG_LEX, np.int64)])

    def _compact_shard(self, s) -> None:
        """Rebuilds one shard's graph from its live slots and re-syncs its
        slice — the other shards' graphs are untouched."""
        g = self._graphs[s]
        mut = self._mut
        fresh = hnsw_build.compact(g, self.params)
        if fresh is None:  # shard emptied: single pad row, like construction
            fresh = hnsw_build.bulk_build(
                self.metric, self.params, ["__pad__"],
                np.zeros((1, self.d), np.float32))
            self._graphs[s] = fresh
            self._row_of[s] = np.full(fresh.n, -1, np.int32)
            mut.slot_glex[s] = np.full(fresh.n, _BIG_LEX, np.int64)
            self._refresh_shard(s)
            return
        row_by_id = mut.row_by_id
        self._graphs[s] = fresh
        self._row_of[s] = np.array(
            [row_by_id.get(id, -1) for id in fresh.ids], np.int32)
        glex = np.full(fresh.n, _BIG_LEX, np.int64)
        idx = np.searchsorted(mut.sorted_ids, np.array(fresh.ids, dtype=str))
        ok = self._row_of[s] >= 0
        glex[ok] = mut.sorted_ranks[idx[ok]]
        mut.slot_glex[s] = glex
        self._refresh_shard(s)

    def _refresh_shard(self, s) -> None:
        """Re-syncs shard ``s``'s slice of the stacked search arrays from
        its (mutated) graph: device-to-device prefix copies for the big
        planes, full host rows for the small id/lex planes (stale slots
        beyond the graph's high-water mark must re-mask after a compact)."""
        g = self._graphs[s]
        st = g._mut
        up_rows = int(np.asarray(g.up_adj).shape[0]) if st is None else (
            st.up_used + 1)
        self._grow_stacked(g.n, up_rows, g.lmax)
        cap, cap_up = self._x.shape[1], self._upa.shape[1]
        n = g.n
        self._x = self._dput(self._x.at[s, :n].set(g.x[:n]),
                             P("shard", None, None))
        self._a0 = self._dput(self._a0.at[s, :n].set(g.a0[:n]),
                              P("shard", None, None))
        self._upi = self._dput(self._upi.at[s, :n].set(g.up_index[:n]),
                               P("shard", None))
        ua = g.up_adj
        ur, ul = min(int(ua.shape[0]), cap_up), int(ua.shape[1])
        self._upa = self._dput(
            self._upa.at[s, :ur, :ul].set(ua[:ur]),
            P("shard", None, None, None))
        lex_row = np.full(cap, _BIG_LEX, np.int32)
        lex_row[:n] = self._mut.slot_glex[s][:n].astype(np.int32)
        self._lex = self._dput(self._lex.at[s].set(jnp.asarray(lex_row)),
                               P("shard", None))
        rows_row = np.full(cap, -1, np.int32)
        rows_row[:n] = self._row_of[s][:n]
        self._rows = self._dput(self._rows.at[s].set(jnp.asarray(rows_row)),
                                P("shard", None))
        self._sync_entry(s)

    def _sync_entry(self, s) -> None:
        g = self._graphs[s]
        self._entries_np[s] = (int(g.entry_slot), int(g.entry_level))
        self.lmax = max(self.lmax, g.lmax)
        self._entries = self._dput(
            jnp.asarray(self._entries_np), P("shard"))

    def _grow_stacked(self, need_cap, need_up, need_lmax) -> None:
        """Grows the stacked planes (slot capacity / upper rows / layers) in
        chunks so search-kernel recompiles stay rare."""
        cap, cap_up = self._x.shape[1], self._upa.shape[1]
        lmax = self._upa.shape[2]
        if need_cap > cap:
            new_cap = ((need_cap + 1023) // 1024) * 1024
            pad = new_cap - cap
            S = self._x.shape[0]
            self._x = self._dput(jnp.concatenate(
                [self._x, jnp.zeros((S, pad, self.d), self._x.dtype)], axis=1),
                P("shard", None, None))
            self._a0 = self._dput(jnp.concatenate(
                [self._a0, jnp.full((S, pad, self._a0.shape[2]), -1,
                                    jnp.int32)], axis=1),
                P("shard", None, None))
            self._upi = self._dput(jnp.concatenate(
                [self._upi, jnp.full((S, pad), -1, jnp.int32)], axis=1),
                P("shard", None))
            self._lex = self._dput(jnp.concatenate(
                [self._lex, jnp.full((S, pad), _BIG_LEX, jnp.int32)], axis=1),
                P("shard", None))
            self._rows = self._dput(jnp.concatenate(
                [self._rows, jnp.full((S, pad), -1, jnp.int32)], axis=1),
                P("shard", None))
        if need_up > cap_up:
            new_up = ((need_up + 255) // 256) * 256
            S = self._upa.shape[0]
            self._upa = self._dput(jnp.concatenate(
                [self._upa, jnp.full(
                    (S, new_up - cap_up) + self._upa.shape[2:], -1,
                    jnp.int32)], axis=1),
                P("shard", None, None, None))
        if need_lmax > lmax:
            S = self._upa.shape[0]
            self._upa = self._dput(jnp.concatenate(
                [self._upa, jnp.full(
                    (S, self._upa.shape[1], need_lmax - lmax,
                     self._upa.shape[3]), -1, jnp.int32)], axis=2),
                P("shard", None, None, None))
            self.lmax = max(self.lmax, need_lmax)

    def _rescatter_lex(self) -> None:
        """Full refresh of the stacked lex plane from the global rank table
        (respace or first mutation) — [S, cap] int32, a tiny transfer."""
        cap = self._lex.shape[1]
        out = np.full((self._lex.shape[0], cap), _BIG_LEX, np.int32)
        for s, glex in enumerate(self._mut.slot_glex):
            out[s, : len(glex)] = glex[:cap].astype(np.int32)
        self._lex = self._dput(jnp.asarray(out), P("shard", None))


class _MeshMut:
    """Host bookkeeping for an incrementally-mutated ShardedHnsw."""

    __slots__ = ("row_by_id", "shard_of", "slot_glex", "sorted_ids",
                 "sorted_ranks", "spacing")


#: stacked-lex pad sentinel — global ranks stay strictly below it
_BIG_LEX = 2**30


def _sharded_search(mesh, x, a0, upi, upa, lex, rows, entries, queries, *,
                    metric, lmax, ef, k):
    return _hnsw_search_program(mesh, metric, lmax, ef, k)(
        x, a0, upi, upa, lex, rows, entries, queries)


@program_cache
def _hnsw_search_program(mesh, metric, lmax, ef, k):
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P("shard", None, None), P("shard", None, None), P("shard", None),
            P("shard", None, None, None), P("shard", None), P("shard", None),
            P("shard", None), P("data", None),
        ),
        out_specs=(P("data", None), P("data", None)),
        check_vma=False,
    )
    def step(x_b, a0_b, upi_b, upa_b, lex_b, rows_b, entries_b, q_b):
        # local block has leading shard axis of size 1. Beams hub-seed from
        # the shard's top-by-level prefix (bulk slots are level-desc sorted;
        # trailing pad slots have no adjacency and fall out of the beam).
        cap = x_b.shape[1]
        h = min(hnsw_device.hub_count(cap), cap)
        slots, raws, dists = hnsw_device._search_impl(
            x_b[0], a0_b[0], upi_b[0], upa_b[0], lex_b[0],
            entries_b[0, 0], entries_b[0, 1], q_b,
            metric=metric, lmax=lmax, ef=ef, limit=k,
            max_steps=hnsw_device.step_bound(ef),
            hub_slots=jnp.arange(h, dtype=jnp.int32), hub_x=x_b[0][:h],
            # zero-vector pad rows score finitely; mask them out of seeding
            hub_valid=rows_b[0][:h] >= 0,
            # tombstoned/pad slots keep routing but never surface, so a
            # mutated shard cannot starve its own candidate set
            valid=rows_b[0] >= 0,
        )  # [b, k]
        # exclude pad nodes (row -1, e.g. the '__pad__' filler on empty
        # shards) BEFORE the merge — with finite distances they would
        # otherwise displace real candidates inside the top-k cut
        grows_raw = rows_b[0][jnp.maximum(slots, 0)]
        ok = (slots >= 0) & (grows_raw >= 0)
        grows = jnp.where(ok, grows_raw, -1)
        glex = jnp.where(ok, lex_b[0][jnp.maximum(slots, 0)], 2**31 - 1)
        dists = jnp.where(ok, dists, jnp.inf)
        # gather per-shard candidates over the interconnect and merge exactly
        d_all = jax.lax.all_gather(dists, "shard", axis=1, tiled=True)
        l_all = jax.lax.all_gather(glex, "shard", axis=1, tiled=True)
        r_all = jax.lax.all_gather(grows, "shard", axis=1, tiled=True)
        w_all = jax.lax.all_gather(raws, "shard", axis=1, tiled=True)
        dm, _, rm, wm = jax.lax.sort((d_all, l_all, r_all, w_all), num_keys=2,
                                     dimension=1)
        top_rows = jnp.where(jnp.isfinite(dm[:, :k]), rm[:, :k], -1)
        return top_rows, wm[:, :k]

    return step
