"""Batched HNSW beam search on device.

The device redesign of the reference's pointer-chasing query path
(hnsw.rs:292-434): the graph lives in fixed-degree adjacency arrays
(``[N, m0]`` int32, -1 padded; compacted ``[U, L, m]`` for upper layers), and
a query batch traverses it inside one jitted program —

* **hub seeding instead of greedy descent**: the upper hierarchy's job is
  finding a good layer-0 entry; one dense ``[B, H] = Q · hubsᵀ`` matmul
  against the top-H nodes by level does it better — it yields S
  independent seeds per query in one pass, while a pointer-chasing
  descent costs a sequential gather chain. Both the single-chip path and
  the mesh path (``parallel.hnsw_mesh``, with pad rows masked via
  ``hub_valid``) seed this way; the descent code remains for callers that
  pass no hubs;
* a widened beam at layer 0: each step expands the ``W`` best unexpanded
  beam entries, gathers their ``W*m0`` neighbor vectors, scores them with a
  matmul, masks visited nodes with a per-query bitset, and keeps the best ``ef``
  via a single-key merge — the array equivalent of the reference's
  candidate/result heap pair;
* **selection in bf16, ordering in f32**: traversal gathers and scores a
  bfloat16 copy of the vectors (half the HBM bytes of the random gathers);
  the final result set re-scores every surviving beam entry from the f32
  block and orders by exact (rank, lex id), so bf16 affects only which nodes
  reach the beam, never how results rank.

Queries are vmapped, so one dispatch serves a whole batch; the visited bitset
costs ``N/8`` bytes per in-flight query, so batches are chunked.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

#: beam entries expanded per iteration (sequential-depth vs redundant-work
#: trade; widening only adds exploration at a given ef)
EXPAND_W = 8


def _chunk_for(n: int) -> int:
    """Query-chunk size per graph size. Compile time of the vmapped beam
    kernel grows pathologically past ~[256, big-graph] (the [B, n/32]
    visited carry seems to cross a compiler threshold); 128-query chunks
    compile in seconds at 1M rows and keep the device busy."""
    return 512 if n <= 2**18 else 128


def hub_count(n: int) -> int:
    """Size of the hub set (entry candidates scored densely by one matmul).
    Scales with n so seed quality holds as the graph grows; the [B, H]
    matmul stays small even at the cap."""
    return min(max(1024, n // 64), 16384, n)


def step_bound(ef: int, w: int = EXPAND_W) -> int:
    """Upper bound on beam iterations. Hub seeds start the beam near the
    target, so convergence is ~ef/W expansions plus slack; the bound caps
    runaway traversals without biting on converged searches (measured
    convergence ~(1-1.5)*ef/W steps from hub seeds on clustered corpora)."""
    return max(2 * ef // max(w, 1), 8) + 8


def _rank_rows(rows, q, metric):
    """Ascending rank distance of gathered rows [k, d] vs q [d]. Inputs may
    be bf16 (traversal mode); accumulation is always f32."""
    if metric == "l2":
        rows = rows.astype(jnp.float32)
        q = q.astype(jnp.float32)
        return jnp.sqrt(jnp.maximum(jnp.sum((rows - q) ** 2, axis=-1), 0.0))
    prec = None if rows.dtype == jnp.bfloat16 else jax.lax.Precision.HIGHEST
    dots = jnp.einsum(
        "...kd,...d->...k", rows, q.astype(rows.dtype),
        precision=prec, preferred_element_type=jnp.float32,
    )
    return 1.0 - dots if metric == "cosine" else -dots


class DeviceGraph:
    """Device-resident snapshot of a host HNSW graph."""

    def __init__(self, host):
        internals = sorted(host._vectors.keys())
        n = len(internals)
        slot_of = {internal: i for i, internal in enumerate(internals)}
        d = host._dim
        x = np.zeros((n, d), dtype=np.float32)
        levels = np.zeros(n, dtype=np.int32)
        ids = []
        for internal, slot in slot_of.items():
            x[slot] = host._vectors[internal]
            levels[slot] = host._levels[internal]
            ids.append(host._external[internal])
        ids = [host._external[i] for i in internals]
        m0 = host.params["m0"]
        m = host.params["m"]
        a0 = np.full((n, m0), -1, dtype=np.int32)
        for internal, slot in slot_of.items():
            conns = host._connections[internal][0] if host._connections[internal] else []
            conns = [slot_of[c] for c in conns if c in slot_of][:m0]
            a0[slot, : len(conns)] = conns

        lmax = int(levels.max()) if n else 0
        upper_slots = np.flatnonzero(levels >= 1)
        up_index = np.full(n, -1, dtype=np.int32)
        up_index[upper_slots] = np.arange(len(upper_slots), dtype=np.int32)
        up_adj = np.full((max(len(upper_slots), 1), max(lmax, 1), m), -1, dtype=np.int32)
        for u, slot in enumerate(upper_slots):
            internal = internals[slot]
            conns = host._connections[internal]
            for layer in range(1, len(conns)):
                row = [slot_of[c] for c in conns[layer] if c in slot_of][:m]
                up_adj[u, layer - 1, : len(row)] = row

        order = np.argsort(np.array(ids, dtype=str), kind="stable")
        lex_rank = np.zeros(n, dtype=np.int32)
        lex_rank[order] = np.arange(n, dtype=np.int32)

        self.ids = ids
        self.n = n
        self.m0 = m0
        self.m = m
        self.lmax = lmax
        self.metric = host.metric
        self.x = jnp.asarray(x)
        self.a0 = jnp.asarray(a0)
        self.up_index = jnp.asarray(up_index)
        self.up_adj = jnp.asarray(up_adj)
        self.lex_rank = jnp.asarray(lex_rank)
        self.entry_slot = jnp.int32(slot_of[host._entry])
        self.entry_level = jnp.int32(levels[slot_of[host._entry]])
        self.valid = None  # host snapshots carry no tombstones
        # hubs: top-H slots by (level desc, slot) — the batched stand-in for
        # the upper hierarchy
        h = hub_count(n)
        hub_order = np.lexsort((np.arange(n), -levels))[:h]
        self._hub_slots_np = hub_order.astype(np.int32)
        self._xb = None
        self._hubs = {}

    @property
    def xb(self):
        """bf16 traversal copy of the vector block (lazy)."""
        if self._xb is None:
            self._xb = self.x.astype(jnp.bfloat16)
        return self._xb

    def hubs(self, dtype=jnp.bfloat16):
        """(hub_slots [H] i32, hub_x [H, d]) in the traversal dtype (lazy)."""
        key = jnp.dtype(dtype).name
        if key not in self._hubs:
            slots = jnp.asarray(self._hub_slots_np)
            block = (self.xb if dtype == jnp.bfloat16 else self.x)[slots]
            self._hubs[key] = (slots, block)
        return self._hubs[key]


def _search_impl(x, a0, up_index, up_adj, lex_rank, entry_slot, entry_level, queries,
                 *, metric, lmax, ef, limit, max_steps, xb=None, expand_w=None,
                 hub_slots=None, hub_x=None, hub_valid=None, valid=None):
    """Traceable core of the batched beam search (also reused per-shard
    inside ``parallel.hnsw_mesh``'s shard_map). ``xb`` is the optional bf16
    traversal block (defaults to ``x``: full-f32 parity mode). When
    ``hub_slots``/``hub_x`` are given the beam seeds from a dense hub scan
    instead of the greedy upper-layer descent; ``hub_valid`` masks hub rows
    that are padding (sharded blocks pad with zero vectors, which would
    otherwise score finitely and displace real seeds). ``valid`` (bool [n])
    masks tombstoned slots out of RESULTS only — soft-deleted nodes keep
    routing beam traffic so incremental deletes never sever the graph."""
    n = x.shape[0]
    m0 = a0.shape[1]
    words = (n + 31) // 32
    xt = x if xb is None else xb
    W = min(expand_w or EXPAND_W, ef)
    use_hubs = hub_slots is not None
    S = min(ef, max(W, 8), hub_x.shape[0] if use_hubs else ef) if use_hubs else 1

    def one(q):
        qt = q.astype(xt.dtype)

        beam_d = jnp.full(ef, jnp.inf, jnp.float32)
        beam_id = jnp.full(ef, -1, jnp.int32)
        beam_exp = jnp.zeros(ef, bool)
        visited = jnp.zeros(words, jnp.uint32)

        if use_hubs:
            # ---- hub seeding: one dense matmul scan of the top-H-by-level
            # nodes replaces the sequential greedy descent
            hd = _rank_rows(hub_x, qt, metric)
            if hub_valid is not None:
                hd = jnp.where(hub_valid, hd, jnp.inf)
            neg, hpos = jax.lax.top_k(-hd, S)
            ok_seed = jnp.isfinite(-neg)
            seeds = jnp.where(ok_seed, hub_slots[hpos], -1)
            beam_d = beam_d.at[:S].set(jnp.where(ok_seed, -neg, jnp.inf))
            beam_id = beam_id.at[:S].set(seeds)
            # top_k positions are distinct, so the scatter-add stays exact;
            # masked seeds scatter out of range and drop
            widx = jnp.where(ok_seed, jnp.maximum(seeds, 0) >> 5, words)
            visited = visited.at[widx].add(
                jnp.uint32(1) << jnp.uint32(jnp.maximum(seeds, 0) & 31),
                mode="drop",
            )
        else:
            # ---- greedy descent over upper layers (hnsw.rs:302-305,336-372).
            # NOTE: the layer-enable flag folds into the loop condition rather
            # than a lax.cond wrapper — cond-wrapping a while_loop under vmap
            # batches every closed-over array (x would broadcast to [B, n, d]).
            def greedy(layer, g, enabled):
                def cond(state):
                    _, _, moved = state
                    return moved

                def body(state):
                    g, gd, _ = state
                    u = up_index[g]
                    row = jnp.where(u >= 0, up_adj[jnp.maximum(u, 0), layer - 1], -1)
                    valid = row >= 0
                    vecs = xt[jnp.maximum(row, 0)]
                    dists = jnp.where(valid, _rank_rows(vecs, qt, metric), jnp.inf)
                    j = jnp.argmin(dists)
                    better = dists[j] < gd
                    return (
                        jnp.where(better, row[j], g),
                        jnp.where(better, dists[j], gd),
                        better,
                    )

                gd = _rank_rows(xt[g][None, :], qt, metric)[0]
                g, _, _ = jax.lax.while_loop(cond, body, (g, gd, enabled))
                return g

            g = entry_slot
            for layer in range(lmax, 0, -1):
                g = greedy(layer, g, layer <= entry_level)
            g0d = _rank_rows(xt[g][None, :], qt, metric)[0]
            beam_d = beam_d.at[0].set(g0d)
            beam_id = beam_id.at[0].set(g)
            visited = visited.at[g >> 5].set(jnp.uint32(1) << jnp.uint32(g & 31))

        # ---- layer-0 beam (hnsw.rs:375-434), widened: W best unexpanded
        # entries expand per iteration. Expanding beyond the strict
        # one-at-a-time frontier only ADDS exploration (recall can only
        # improve at the same ef) and cuts the sequential iteration count
        # ~W-fold — the dominant latency term for big/tight graphs.
        def cond(state):
            _, _, _, _, step, done = state
            return jnp.logical_and(step < max_steps, jnp.logical_not(done))

        def body(state):
            beam_d, beam_id, beam_exp, visited, step, _ = state
            unexp = jnp.where((~beam_exp) & (beam_id >= 0), beam_d, jnp.inf)
            neg_top, jpos = jax.lax.top_k(-unexp, W)
            top_d = -neg_top
            # reference termination: stop when the best unexpanded entry
            # cannot improve the result set (beam not full => worst = inf)
            worst = jnp.max(beam_d)
            done = jnp.isinf(top_d[0]) | (top_d[0] > worst)
            expand_ok = jnp.isfinite(top_d) & ~done

            nodes = jnp.where(expand_ok, beam_id[jpos], -1)
            nbrs = a0[jnp.maximum(nodes, 0)].reshape(-1)  # [W * m0]
            valid = (nbrs >= 0) & jnp.repeat(expand_ok, m0)
            # two expanded nodes can share a neighbor: dedup within the step
            # (the visited scatter-add needs unique bits, and duplicate beam
            # entries would corrupt the result set). Pairwise masking beats a
            # sort here: one [E, E] bool compare.
            E = nbrs.shape[0]
            key = jnp.where(valid, nbrs, -1)
            iota = jax.lax.iota(jnp.int32, E)
            dup = jnp.any((key[None, :] == key[:, None]) &
                          (iota[None, :] < iota[:, None]), axis=1)
            valid = valid & ~dup

            safe = jnp.maximum(nbrs, 0)
            word = safe >> 5
            bit = jnp.uint32(1) << jnp.uint32(safe & 31)
            seen = (visited[word] & bit) != 0
            fresh = valid & ~seen
            visited = visited.at[word].add(jnp.where(fresh, bit, jnp.uint32(0)))
            nd = jnp.where(fresh, _rank_rows(xt[safe], qt, metric), jnp.inf)
            cat_d = jnp.concatenate([beam_d, nd])
            cat_id = jnp.concatenate([beam_id, jnp.where(fresh, nbrs, -1)])
            new_exp = beam_exp.at[jpos].set(beam_exp[jpos] | expand_ok)
            cat_exp = jnp.concatenate([new_exp, jnp.zeros(E, bool)])
            # single-key distance merge; interior ties resolve by concat
            # position — the exact epilogue below restores (f32 rank, lex id)
            # ordering for the results
            cat_d, cat_id, cat_exp = jax.lax.sort((cat_d, cat_id, cat_exp),
                                                  num_keys=1)
            return (cat_d[:ef], cat_id[:ef], cat_exp[:ef], visited, step + 1,
                    done)

        beam_d, beam_id, _, _, _, _ = jax.lax.while_loop(
            cond, body, (beam_d, beam_id, beam_exp, visited, 0, False)
        )

        # ---- exact epilogue: re-score every surviving beam entry from the
        # f32 block and order by (f32 rank, lex id) — hnsw.rs:322-333's
        # (dist, external_id) sort — so bf16 traversal never affects ranking
        ok = beam_id >= 0
        safe = jnp.maximum(beam_id, 0)
        if valid is not None:
            ok = ok & valid[safe]
            beam_id = jnp.where(ok, beam_id, -1)
        rank32 = jnp.where(ok, _rank_rows(x[safe], q, metric), jnp.inf)
        lex = jnp.where(ok, lex_rank[safe], 2**31 - 1)
        rank32, _, beam_id = jax.lax.sort((rank32, lex, beam_id), num_keys=2)

        top_id = beam_id[:limit]
        top_d = rank32[:limit]
        safe = jnp.maximum(top_id, 0)
        if metric == "l2":
            raw = top_d
        else:
            raw = jnp.einsum(
                "kd,d->k", x[safe], q,
                precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32,
            )
        return top_id, jnp.where(top_id >= 0, raw, jnp.inf), top_d

    return jax.vmap(one)(queries)


_search_kernel = functools.partial(jax.jit, static_argnames=(
    "metric", "lmax", "ef", "limit", "max_steps", "expand_w"))(_search_impl)


def search(host, queries: np.ndarray, limit: int) -> list:
    """Batched device search over a host HNSW graph; returns per-query
    ``[(external_id, raw)]`` hit lists."""
    if host._device is None or host._device_version != host._version:
        host._device = host._bulk if host._bulk is not None else DeviceGraph(host)
        host._device_version = host._version
    graph = host._device
    ef = max(host.params["ef_search"], limit)
    ef = min(ef, graph.n)
    k = min(limit, graph.n)
    traversal = getattr(host, "traversal", "bf16")
    xb = graph.xb if traversal == "bf16" else None
    hub_slots, hub_x = graph.hubs(jnp.bfloat16 if traversal == "bf16" else jnp.float32)
    valid = getattr(graph, "valid", None)
    hub_valid = graph.hub_validity() if valid is not None else None
    w = host.params.get("expand_w") or EXPAND_W
    max_steps = step_bound(ef, w)

    out = []
    queries = np.asarray(queries, dtype=np.float32)
    chunk_size = _chunk_for(graph.n)
    for start in range(0, queries.shape[0], chunk_size):
        chunk = queries[start : start + chunk_size]
        real = chunk.shape[0]
        if real < chunk_size and queries.shape[0] > chunk_size:
            # pad partial chunks so every call shares ONE compiled shape —
            # kernel compiles cost minutes on remote-compile backends
            chunk = np.concatenate(
                [chunk, np.zeros((chunk_size - real, chunk.shape[1]), np.float32)]
            )
        ids, raws, _dists = jax.device_get(
            _search_kernel(
                graph.x, graph.a0, graph.up_index, graph.up_adj, graph.lex_rank,
                graph.entry_slot, graph.entry_level, jnp.asarray(chunk),
                metric=graph.metric, lmax=graph.lmax, ef=ef, limit=k,
                max_steps=max_steps, xb=xb, hub_slots=hub_slots, hub_x=hub_x,
                hub_valid=hub_valid, valid=valid, expand_w=w,
            )
        )
        ids, raws = ids[:real], raws[:real]
        for row_ids, row_raws in zip(ids, raws):
            hits = []
            for slot, raw in zip(row_ids, row_raws):
                if slot < 0:
                    continue
                hits.append((graph.ids[int(slot)], float(raw)))
            out.append(hits)
    return out
