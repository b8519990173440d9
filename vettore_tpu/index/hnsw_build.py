"""Bulk HNSW construction on device: wave insertion.

The reference builds its graph one sequential insert at a time
(hnsw.rs:152-244) — inherently pointer-chasing and far too slow for
million-scale ingest on a host loop. The device redesign inserts in
*waves*:

* nodes are ordered by (level desc, id) — deterministic FNV-1a levels mean
  the first node is the entry for the whole build, and "already inserted"
  is simply ``slot < wave_start``;
* each wave runs the reference's insert search batched on device: greedy
  descent to the node's level, an ``ef_construction`` beam per layer, and
  neighbor truncation to m/m0 by (distance, id);
* nodes inside a wave cannot see each other through the frozen graph, so
  intra-wave candidates come from a ``[B, B]`` matmul distance matrix merged
  into each layer's beam results;
* reciprocal edges apply as one scatter/segment program per layer: edges
  sort by (dst, dist), cap incoming per node, union with the node's existing
  row, rescore, dedup, and prune — the batched equivalent of
  hnsw.rs:220-236's add-then-prune.

The produced graph diverges from sequential insertion order (expected; the
parity gate is recall@k, SURVEY §7), but levels, degrees, and tie-breaking
stay reference-deterministic.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .hnsw import level_for

_BIG32 = 2**31 - 1


def _rank_block(rows, q, metric):
    """rows [..., k, d] vs q [..., d] → ascending rank distances [..., k].
    Inputs may be bf16 (selection-only traversal); accumulation is f32."""
    if metric == "l2":
        rows = rows.astype(jnp.float32)
        q = q.astype(jnp.float32)
        return jnp.sqrt(jnp.maximum(jnp.sum((rows - q[..., None, :]) ** 2, axis=-1), 0.0))
    prec = None if rows.dtype == jnp.bfloat16 else jax.lax.Precision.HIGHEST
    dots = jnp.einsum(
        "...kd,...d->...k", rows, q.astype(rows.dtype),
        precision=prec, preferred_element_type=jnp.float32,
    )
    return 1.0 - dots if metric == "cosine" else -dots


#: use diversity-based neighbor selection (Malkov's select-neighbors
#: heuristic) during bulk construction. The reference prunes by plain
#: distance truncation (hnsw.rs:437-465), which severs inter-cluster bridges
#: on clustered corpora and caps recall; the heuristic keeps a candidate only
#: when it is closer to the base point than to every already-kept neighbor,
#: preserving one edge per "direction". Pure construction-side improvement —
#: query semantics are unchanged.
HEURISTIC_SELECTION = True


def _pairwise_rank(cvecs, metric):
    """Candidate-to-candidate rank distances [..., C, C]. Selection-only, so
    the default matmul precision (TF32 or bf16 inputs) is fine."""
    dots = jnp.einsum("...cd,...ed->...ce", cvecs, cvecs,
                      preferred_element_type=jnp.float32)
    if metric == "l2":
        sq = jnp.einsum("...cd,...cd->...c", cvecs, cvecs,
                        preferred_element_type=jnp.float32)
        return jnp.sqrt(jnp.maximum(sq[..., :, None] + sq[..., None, :] - 2 * dots, 0.0))
    return 1.0 - dots if metric == "cosine" else -dots


def _heuristic_select(cand_ids, cand_dists, P, deg):
    """Diversity selection over candidates sorted ascending by distance-to-base.

    Keeps candidate j when it is closer to the base than to every kept
    neighbor; remaining slots fill with the closest pruned candidates
    (hnswlib's keepPrunedConnections). Shapes: cand_ids/cand_dists [..., C],
    P [..., C, C] pairwise candidate distances. Returns ids [..., deg].
    """
    C = cand_ids.shape[-1]
    valid = jnp.isfinite(cand_dists) & (cand_ids >= 0)

    # sequential scan in ascending-distance order: mdk[i] tracks candidate
    # i's distance to the closest KEPT neighbor so far. (A deg-iteration
    # keep-event variant was tried and measured SLOWER — the per-iteration
    # take_along_axis over [.., C, C] costs more than the extra iterations.)
    def step(j, state):
        mdk, count, kept = state
        keep = valid[..., j] & (count < deg) & (cand_dists[..., j] < mdk[..., j])
        mdk = jnp.where(keep[..., None], jnp.minimum(mdk, P[..., :, j]), mdk)
        kept = kept.at[..., j].set(keep)
        return mdk, count + keep, kept

    mdk0 = jnp.full(cand_dists.shape, jnp.inf, jnp.float32)
    count0 = jnp.zeros(cand_dists.shape[:-1], jnp.int32)
    kept0 = jnp.zeros(valid.shape, bool)
    _, _, kept = jax.lax.fori_loop(0, C, step, (mdk0, count0, kept0))

    # kept candidates first (in distance order), then pruned-but-valid fills
    pos = jax.lax.broadcasted_iota(jnp.int32, valid.shape, valid.ndim - 1)
    key = jnp.where(kept, pos, jnp.where(valid, C + pos, 2 * C + pos))
    order = jnp.argsort(key, axis=-1)
    sel = jnp.take_along_axis(cand_ids, order[..., :deg], axis=-1)
    sel_d = jnp.take_along_axis(cand_dists, order[..., :deg], axis=-1)
    sel_key = jnp.take_along_axis(key, order[..., :deg], axis=-1)
    ok = sel_key < 2 * C
    return jnp.where(ok, sel, -1), jnp.where(ok, sel_d, jnp.inf)


class BulkGraph:
    """DeviceGraph-compatible result of a bulk build (see hnsw_device.search).

    Arrays may be capacity-padded past ``n`` once the graph has been mutated
    incrementally (``incremental_put``/``incremental_delete``): ``n`` is the
    slot high-water mark, ``valid`` (device bool [cap] or None) masks
    tombstoned slots out of results, and ``live`` is the record count."""

    def __init__(self, ids, n, m, m0, lmax, metric, x, a0, up_index, up_adj,
                 lex_rank, entry_slot, entry_level, levels, *, valid=None,
                 lex_spacing=1):
        self.ids = ids
        self.n = n
        self.m = m
        self.m0 = m0
        self.lmax = lmax
        self.metric = metric
        self.x = x
        self.a0 = a0
        self.up_index = up_index
        self.up_adj = up_adj
        self.lex_rank = lex_rank
        self.entry_slot = entry_slot
        self.entry_level = entry_level
        self.levels = levels
        self.valid = valid
        self.lex_spacing = lex_spacing
        self._xb = None
        self._hubs = {}
        self._mut = None  # _MutState once incrementally mutated

    @property
    def live(self) -> int:
        return self.n - (self._mut.dead if self._mut is not None else 0)

    @property
    def xb(self):
        """bf16 traversal copy of the vector block (lazy)."""
        if self._xb is None:
            self._xb = self.x.astype(jnp.bfloat16)
        return self._xb

    def hubs(self, dtype=jnp.bfloat16):
        """(hub_slots [H] i32, hub_x [H, d]) — bulk slots are already
        (level desc, id) ordered, so the hub set is simply the first H."""
        from .hnsw_device import hub_count

        key = jnp.dtype(dtype).name
        if key not in self._hubs:
            h = hub_count(self.n)
            slots = jnp.arange(h, dtype=jnp.int32)
            block = (self.xb if dtype == jnp.bfloat16 else self.x)[:h]
            self._hubs[key] = (slots, block)
        return self._hubs[key]

    def hub_validity(self):
        """Liveness mask for the hub prefix (None when nothing is dead)."""
        if self.valid is None:
            return None
        from .hnsw_device import hub_count

        return self.valid[: hub_count(self.n)]


GRAPH_MAGIC = "vettore-tpu-hnsw-graph-v1"


def save_graph(graph: BulkGraph, path: str, *, include_x: bool = True) -> None:
    """Serializes a bulk-built graph to an ``.npz`` (atomic tmp+rename).

    The graph is an *acceleration structure* — the canonical data always
    lives in the host store (reference invariant, README.md:410-415) — so
    this is a cache format, not a durability format: rebuilding from
    canonical records must always produce an equivalent graph. ``include_x=
    False`` omits the [n, d] vector block for callers that already hold the
    same vectors device-resident (pass ``x_device`` at load)."""
    import tempfile

    n = graph.n
    up_used = graph._mut.up_used if graph._mut is not None else None
    up_adj = np.asarray(graph.up_adj)
    if up_used is not None:
        up_adj = up_adj[: max(up_used, 1)]
    payload = {
        "magic": np.array(GRAPH_MAGIC),
        "ids": np.array(graph.ids, dtype=str),
        "n": np.int64(n),
        "m": np.int64(graph.m),
        "m0": np.int64(graph.m0),
        "lmax": np.int64(graph.lmax),
        "metric": np.array(graph.metric),
        "a0": np.asarray(graph.a0)[:n],
        "up_index": np.asarray(graph.up_index)[:n],
        "up_adj": up_adj,
        "lex_rank": np.asarray(graph.lex_rank)[:n],
        "entry_slot": np.int64(int(graph.entry_slot)),
        "entry_level": np.int64(int(graph.entry_level)),
        "levels": np.asarray(graph.levels)[:n],
        "lex_spacing": np.int64(graph.lex_spacing),
    }
    if graph._mut is not None and graph._mut.dead:
        payload["valid"] = graph._mut.valid_np[:n].copy()
    if include_x:
        payload["x"] = np.asarray(graph.x)[:n]
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_graph(path: str, *, x_device=None) -> BulkGraph:
    """Loads a graph saved by :func:`save_graph`. ``x_device`` supplies the
    [n, d] device-resident vector block in graph slot order when the file was
    written with ``include_x=False`` (or to share one HBM copy)."""
    with np.load(path, allow_pickle=False) as z:
        if str(z["magic"]) != GRAPH_MAGIC:
            raise ValueError(f"not a vettore graph file: {path}")
        ids = [str(i) for i in z["ids"]]
        n = int(z["n"])
        if x_device is not None:
            x = x_device
            if x.shape[0] != n:
                raise ValueError("x_device row count does not match graph")
        elif "x" in z:
            x = jnp.asarray(z["x"])
        else:
            raise ValueError("graph file has no vector block; pass x_device")
        valid = None
        if "valid" in z and not bool(z["valid"].all()):
            valid = jnp.asarray(z["valid"])
        graph = BulkGraph(
            ids=ids, n=n, m=int(z["m"]), m0=int(z["m0"]), lmax=int(z["lmax"]),
            metric=str(z["metric"]), x=x,
            a0=jnp.asarray(z["a0"]), up_index=jnp.asarray(z["up_index"]),
            up_adj=jnp.asarray(z["up_adj"]), lex_rank=jnp.asarray(z["lex_rank"]),
            entry_slot=jnp.int32(int(z["entry_slot"])),
            entry_level=jnp.int32(int(z["entry_level"])),
            levels=np.asarray(z["levels"]),
            valid=valid,
            lex_spacing=int(z["lex_spacing"]) if "lex_spacing" in z else 1,
        )
        if valid is not None:
            # loaded tombstones: rebuild the mutation bookkeeping so live
            # counts, compaction pressure, and re-inserts stay correct
            _ensure_mutable(graph, valid_np=np.asarray(z["valid"]))
        return graph


#: beam entries expanded per construct-search iteration (same widened-beam
#: scheme as the query kernel: exploration only grows at a given ef, while
#: sequential depth and per-step merge cost drop ~W-fold); env override is
#: for build-throughput experiments
BUILD_EXPAND_W = int(os.environ.get("VETTORE_BUILD_W", "4"))


def build_step_bound(efc: int, w: int = BUILD_EXPAND_W) -> int:
    """Bound on construct-beam iterations (~efc expansions at W per step,
    plus exploration slack); replaces the old 4*efc+64 worst-case."""
    return max(3 * efc // max(w, 1), 24) + 16


def _beam_layer(xt, adj_rows_fn, q, g, start, enabled, *, metric, ef,
                words, max_steps, expand_w=BUILD_EXPAND_W, seeds=None):
    """Widened unsorted beam over one layer (same scheme as hnsw_device's
    query kernel: selection via single-key top-k merges, bf16 gathers when
    ``xt`` is bf16; callers re-sort candidates exactly before selection).
    ``g`` is the entry slot (must be < start, i.e. already inserted).
    ``enabled`` is a traced flag: disabled lanes seed an empty beam and
    terminate immediately (loops must stay mask-driven — wrapping them in
    ``lax.cond`` under vmap batches every closed-over array). ``seeds``
    (dists [S], slots [S]; non-finite = absent) hub-seeds the beam instead
    of the single entry ``g``."""
    W = min(expand_w, ef)
    beam_d = jnp.full(ef, jnp.inf, jnp.float32)
    beam_id = jnp.full(ef, -1, jnp.int32)
    beam_exp = jnp.zeros(ef, bool)
    visited = jnp.zeros(words, jnp.uint32)

    if seeds is None:
        g0d = _rank_block(xt[g][None, :], q, metric)[0]
        beam_d = beam_d.at[0].set(jnp.where(enabled, g0d, jnp.inf))
        beam_id = beam_id.at[0].set(jnp.where(enabled, g, -1))
        visited = visited.at[g >> 5].set(
            jnp.where(enabled, jnp.uint32(1) << jnp.uint32(g & 31), jnp.uint32(0))
        )
    else:
        sd, si = seeds
        s_count = sd.shape[0]
        ok = enabled & jnp.isfinite(sd) & (si >= 0)
        beam_d = beam_d.at[:s_count].set(jnp.where(ok, sd, jnp.inf))
        beam_id = beam_id.at[:s_count].set(jnp.where(ok, si, -1))
        # seed slots are distinct (top_k positions); disabled lanes scatter
        # to an out-of-range word and drop
        widx = jnp.where(ok, jnp.maximum(si, 0) >> 5, words)
        visited = visited.at[widx].add(
            jnp.uint32(1) << jnp.uint32(jnp.maximum(si, 0) & 31), mode="drop"
        )

    def cond(state):
        *_, step, done = state
        return jnp.logical_and(step < max_steps, jnp.logical_not(done))

    def body(state):
        beam_d, beam_id, beam_exp, visited, step, _ = state
        unexp = jnp.where((~beam_exp) & (beam_id >= 0), beam_d, jnp.inf)
        neg_top, jpos = jax.lax.top_k(-unexp, W)
        top_d = -neg_top
        worst = jnp.max(beam_d)
        done = jnp.isinf(top_d[0]) | (top_d[0] > worst)
        expand_ok = jnp.isfinite(top_d) & ~done

        nodes = jnp.where(expand_ok, beam_id[jpos], -1)
        nbrs = jax.vmap(adj_rows_fn)(jnp.maximum(nodes, 0)).reshape(-1)  # [W*deg]
        valid = (nbrs >= 0) & (nbrs < start) & jnp.repeat(expand_ok, nbrs.shape[0] // W)
        # dedup within the step (visited scatter-add requires unique bits):
        # pairwise masking on the VPU instead of a bitonic sort
        E = nbrs.shape[0]
        key = jnp.where(valid, nbrs, -1)
        iota = jax.lax.iota(jnp.int32, E)
        dup = jnp.any((key[None, :] == key[:, None]) & (iota[None, :] < iota[:, None]),
                      axis=1)
        valid = valid & ~dup

        safe = jnp.maximum(nbrs, 0)
        word = safe >> 5
        bit = jnp.uint32(1) << jnp.uint32(safe & 31)
        seen = (visited[word] & bit) != 0
        fresh = valid & ~seen
        visited = visited.at[word].add(jnp.where(fresh, bit, jnp.uint32(0)))
        nd = jnp.where(fresh, _rank_block(xt[safe], q, metric), jnp.inf)
        cat_d = jnp.concatenate([beam_d, nd])
        cat_id = jnp.concatenate([beam_id, jnp.where(fresh, nbrs, -1)])
        new_exp = beam_exp.at[jpos].set(beam_exp[jpos] | expand_ok)
        cat_exp = jnp.concatenate([new_exp, jnp.zeros(E, bool)])
        neg_best, keep = jax.lax.top_k(-cat_d, ef)
        return -neg_best, cat_id[keep], cat_exp[keep], visited, step + 1, done

    beam_d, beam_id, *_ = jax.lax.while_loop(
        cond, body, (beam_d, beam_id, beam_exp, visited, 0, False)
    )
    return beam_d, beam_id


def _greedy_upper(xt, up_adj, up_index, q, g, start, enabled, layer, metric):
    """Greedy descent on one upper layer; ``enabled`` lanes iterate, others
    return ``g`` unchanged after zero iterations."""

    def cond(state):
        return state[2]

    def body(state):
        g, gd, _ = state
        u = up_index[g]
        row = jnp.where(u >= 0, up_adj[jnp.maximum(u, 0), layer - 1], -1)
        valid = (row >= 0) & (row < start)
        dists = jnp.where(valid, _rank_block(xt[jnp.maximum(row, 0)], q, metric), jnp.inf)
        j = jnp.argmin(dists)
        better = dists[j] < gd
        return jnp.where(better, row[j], g), jnp.where(better, dists[j], gd), better

    gd = _rank_block(xt[g][None, :], q, metric)[0]
    g, _, _ = jax.lax.while_loop(cond, body, (g, gd, enabled))
    return g


@functools.partial(
    jax.jit,
    static_argnames=("metric", "efc", "m", "m0", "lmax", "lmax_wave", "beam_steps",
                     "hub_cap"),
    donate_argnums=(2, 3),
)
def _wave_step(x, xt, a0, up_adj, up_index, lex_rank, levels, wave_slots, wave_mask,
               start, entry_slot, entry_level, *, metric, efc, m, m0, lmax,
               lmax_wave, beam_steps, hub_cap=0):
    """Inserts one wave: batched construct-search + forward edges + reciprocal
    prune. ``a0`` [n+1, m0] and ``up_adj`` [cap_up+1, max(lmax,1), m] carry a
    trailing trash row. Returns updated (a0, up_adj).

    ``lmax`` is the global top layer (descent must traverse it); ``lmax_wave``
    is the highest level of any node IN this wave — selection and reciprocal
    work only runs for layers <= lmax_wave, which skips most upper-layer work
    for most waves (insertion order is level-descending, so late waves are
    all level 0)."""
    n = x.shape[0]
    words = (n + 31) // 32
    B = wave_slots.shape[0]
    trash_up = up_adj.shape[0] - 1

    # ---- intra-wave candidate matrix (peers can't be reached via the frozen
    # graph, so they compete through a dense [B, B] distance block)
    wave_x = x[wave_slots]
    if metric == "l2":
        sq = jnp.sum(wave_x**2, axis=1)
        dots = jnp.dot(wave_x, wave_x.T, precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)
        peer_rank = jnp.sqrt(jnp.maximum(sq[:, None] + sq[None, :] - 2 * dots, 0.0))
    else:
        dots = jnp.dot(wave_x, wave_x.T, precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)
        peer_rank = 1.0 - dots if metric == "cosine" else -dots
    eye = jnp.eye(B, dtype=bool)
    peer_rank = jnp.where(eye | ~wave_mask[None, :], jnp.inf, peer_rank)
    wave_levels = levels[wave_slots]
    wave_lex = lex_rank[wave_slots]

    # ---- per-node construct search
    hub_x = xt[:hub_cap] if hub_cap else None

    def search_one(slot, my_mask, peer_row):
        q = x[slot]
        qt = xt[slot]
        lv = levels[slot]
        has_graph = start > 0
        g = jnp.where(has_graph, entry_slot, 0)

        if hub_cap:
            # hub seeding for the layer-0 construct beam: a dense scan of
            # the top-by-level prefix (only already-inserted slots < start
            # are eligible) starts the beam near convergence — fewer
            # sequential expansions than entry descent
            hd = _rank_block(hub_x, qt, metric)
            hd = jnp.where(jnp.arange(hub_cap) < start, hd, jnp.inf)
            # few seeds: construct beams refine around each seed basin, so
            # many seeds INCREASE total expansions at efc-scale beams
            s_count = min(4, hub_cap)
            neg, hpos = jax.lax.top_k(-hd, s_count)
            hub_seeds = (-neg, jnp.where(jnp.isfinite(-neg), hpos.astype(jnp.int32), -1))
        else:
            hub_seeds = None

        deg_max = max(m, m0)
        sel_ids = jnp.full((lmax_wave + 1, deg_max), -1, jnp.int32)
        sel_d = jnp.full((lmax_wave + 1, deg_max), jnp.inf, jnp.float32)

        # layers above every wave node's level: pure greedy descent
        for l in range(lmax, lmax_wave, -1):
            g = _greedy_upper(xt, up_adj, up_index, qt, g, start,
                              has_graph & (l <= entry_level), l, metric)

        for l in range(lmax_wave, -1, -1):
            deg = m0 if l == 0 else m
            in_graph_layer = has_graph & (l <= entry_level)
            descend = in_graph_layer & (l > lv)
            do_beam = in_graph_layer & (l <= lv)

            if l >= 1:
                g = _greedy_upper(xt, up_adj, up_index, qt, g, start, descend, l, metric)
                adj_fn = lambda node, _l=l: jnp.where(
                    up_index[node] >= 0, up_adj[jnp.maximum(up_index[node], 0), _l - 1], -1
                )
            else:
                adj_fn = lambda node: a0[node]

            bd, bi = _beam_layer(xt, adj_fn, qt, g, start, do_beam,
                                 metric=metric, ef=efc, words=words,
                                 max_steps=beam_steps,
                                 seeds=hub_seeds if l == 0 else None)

            # merge graph beam with intra-wave peers of sufficient level
            active = my_mask & (l <= lv)
            pmask = (wave_levels >= l) & jnp.isfinite(peer_row) & active
            pd = jnp.where(pmask, peer_row, jnp.inf)
            top_pd, ppos = jax.lax.top_k(-pd, min(deg, B))
            top_pd = -top_pd
            pids = jnp.where(jnp.isfinite(top_pd), wave_slots[ppos], -1)

            cat_d = jnp.concatenate([bd, top_pd])
            cat_id = jnp.concatenate([bi, pids])
            cat_lex = jnp.where(cat_id >= 0, lex_rank[jnp.maximum(cat_id, 0)], _BIG32)
            cat_d, _, cat_id = jax.lax.sort((cat_d, cat_lex, cat_id), num_keys=2)
            if HEURISTIC_SELECTION:
                cvecs = xt[jnp.maximum(cat_id, 0)]
                P = _pairwise_rank(cvecs, metric)
                chosen, chosen_d = _heuristic_select(cat_id, cat_d, P, deg)
            else:
                chosen, chosen_d = cat_id[:deg], cat_d[:deg]
            sel_ids = sel_ids.at[l, :deg].set(jnp.where(active, chosen, -1))
            sel_d = sel_d.at[l, :deg].set(jnp.where(active, chosen_d, jnp.inf))

            # next layer's entry = closest GRAPH candidate (a wave peer has no
            # adjacency row yet and would stall the next layer's beam)
            g = jnp.where(jnp.logical_and(do_beam, bi[0] >= 0), bi[0], g)
        return sel_ids, sel_d

    sel_ids, sel_d = jax.vmap(search_one)(wave_slots, wave_mask, peer_rank)
    # sel_ids: [B, lmax_wave+1, deg_max]

    # ---- forward edges
    safe_slots = jnp.where(wave_mask, wave_slots, n)  # trash row n
    a0 = a0.at[safe_slots].set(sel_ids[:, 0, :m0])
    for l in range(1, lmax_wave + 1):
        rows = jnp.where(
            wave_mask & (up_index[wave_slots] >= 0) & (levels[wave_slots] >= l),
            up_index[wave_slots],
            trash_up,
        )
        up_adj = up_adj.at[rows, l - 1].set(sel_ids[:, l, :m])

    # ---- reciprocal edges + prune, one segment program per layer
    for l in range(0, lmax_wave + 1):
        deg = m0 if l == 0 else m
        src = jnp.repeat(wave_slots, deg)
        src_ok = jnp.repeat(wave_mask, deg)
        dst = sel_ids[:, l, :deg].reshape(-1)
        dist = sel_d[:, l, :deg].reshape(-1)
        valid = (dst >= 0) & src_ok
        E = dst.shape[0]

        dkey = jnp.where(valid, dst, n)
        slex = jnp.where(valid, lex_rank[jnp.maximum(src, 0)], _BIG32)
        dkey, dist_s, _, src_s = jax.lax.sort(
            (dkey, jnp.where(valid, dist, jnp.inf), slex, src), num_keys=3
        )
        iota = jnp.arange(E, dtype=jnp.int32)
        first = jnp.concatenate([jnp.array([True]), dkey[1:] != dkey[:-1]])
        seg_start = jax.lax.cummax(jnp.where(first, iota, 0))
        seg_rank = iota - seg_start
        keep = (dkey < n) & (seg_rank < deg)

        inc = jnp.full((n + 1, deg), -1, jnp.int32)
        inc = inc.at[jnp.where(keep, dkey, n), jnp.minimum(seg_rank, deg - 1)].set(
            jnp.where(keep, src_s, -1)
        )

        proc = first & (dkey < n)
        rows = jnp.where(proc, dkey, n)
        if l == 0:
            up_rows = None
            exist = a0[rows]
        else:
            up_rows = jnp.where(proc, up_index[jnp.minimum(rows, n - 1)], trash_up)
            up_rows = jnp.where(up_rows >= 0, up_rows, trash_up)
            exist = up_adj[up_rows, l - 1]
        cand = jnp.concatenate([exist, inc[rows]], axis=1)  # [E, 2*deg]

        # the candidate rescoring gathers [chunk, 2*deg, d] vectors — chunk it
        # so the working set stays bounded regardless of wave size
        chunk = 4096
        pad = (-E) % chunk
        rows_p = jnp.pad(rows, (0, pad), constant_values=n)
        proc_p = jnp.pad(proc, (0, pad))
        cand_p = jnp.pad(cand, ((0, pad), (0, 0)), constant_values=-1)

        def prune_chunk(args):
            rows_c, proc_c, cand_c = args
            cvalid = (cand_c >= 0) & (cand_c != rows_c[:, None]) & proc_c[:, None]
            csafe = jnp.maximum(cand_c, 0)
            cd = jnp.where(
                cvalid,
                _rank_block(xt[csafe], xt[jnp.minimum(rows_c, n - 1)], metric),
                jnp.inf,
            )
            clex = jnp.where(cvalid, lex_rank[csafe], _BIG32)
            cd, clex_s, cand_s = jax.lax.sort(
                (cd, clex, jnp.where(cvalid, cand_c, -1)), num_keys=2, dimension=1
            )
            dup = jnp.concatenate(
                [
                    jnp.zeros((cand_s.shape[0], 1), bool),
                    (cand_s[:, 1:] == cand_s[:, :-1]) & (cand_s[:, 1:] >= 0),
                ],
                axis=1,
            )
            cd = jnp.where(dup, jnp.inf, cd)
            cand_s = jnp.where(dup, -1, cand_s)
            clex_s = jnp.where(dup, _BIG32, clex_s)
            if HEURISTIC_SELECTION:
                # valid entries stay ascending after dup-masking; infs never
                # get kept, so no re-sort is needed before the scan
                cvecs2 = xt[jnp.maximum(cand_s, 0)]
                P = _pairwise_rank(cvecs2, metric)
                chosen, _ = _heuristic_select(cand_s, cd, P, deg)
                return chosen
            _, _, cand_s = jax.lax.sort((cd, clex_s, cand_s), num_keys=2, dimension=1)
            return cand_s[:, :deg]

        shaped = (
            rows_p.reshape(-1, chunk),
            proc_p.reshape(-1, chunk),
            cand_p.reshape(-1, chunk, cand.shape[1]),
        )
        pruned = jax.lax.map(prune_chunk, shaped).reshape(-1, deg)[:E]
        if l == 0:
            a0 = a0.at[rows].set(jnp.where(proc[:, None], pruned, a0[rows]))
        else:
            up_adj = up_adj.at[up_rows, l - 1].set(
                jnp.where(proc[:, None], pruned, up_adj[up_rows, l - 1])
            )

    return a0, up_adj


def _prep_order(ids, max_level: int, n: int):
    """Shared build preamble: deterministic FNV-1a levels, (level desc, id)
    slot order, lex tie-break ranks, and the upper-layer row map. Returns
    ``(ids_sorted, order, levels, lex_rank, lmax, up_index, cap_up)``."""
    from .. import native

    str_ids = [str(i) for i in ids]
    levels = native.levels_batch(str_ids, max_level)
    if levels is None:  # no C++ toolchain: pure-Python fallback
        levels = np.array([level_for(i, max_level) for i in str_ids], dtype=np.int32)
    id_arr = np.array(str_ids, dtype=str)
    order = np.lexsort((id_arr, -levels))  # (level desc, id asc)
    ids_sorted = [str(id_arr[i]) for i in order]
    levels = levels[order]

    lex = np.argsort(np.array(ids_sorted, dtype=str), kind="stable")
    lex_rank = np.zeros(n, dtype=np.int32)
    lex_rank[lex] = np.arange(n, dtype=np.int32)

    lmax = int(levels.max()) if n else 0
    upper = np.flatnonzero(levels >= 1)
    up_index = np.full(n, -1, dtype=np.int32)
    up_index[upper] = np.arange(len(upper), dtype=np.int32)
    return ids_sorted, order, levels, lex_rank, lmax, up_index, len(upper)


#: graphs at least this large bulk-build through the kNN-block construction
#: (hnsw_knn_build.py) by default; below it the wave build's compile set is
#: cheaper and the corpus fits one wave anyway. ``build="wave"|"knn"``
#: overrides per index.
KNN_BUILD_MIN = 20_000


def bulk_build(metric: str, params: dict, ids, vectors=None, *, wave: int | None = None,
               beam_steps: int | None = None, x_device=None) -> BulkGraph:
    """Builds a full graph from scratch on device; returns a BulkGraph.

    Vectors come from ``vectors`` (host [n, d], uploaded once) or
    ``x_device`` (an existing device-resident [n, d] block in ``ids`` order —
    e.g. a flat index's block — permuted on device, no re-transfer).

    Two construction algorithms produce the same BulkGraph layout:

    * ``knn`` (default at scale): cluster-blocked kNN-graph construction —
      dense matmuls end to end (hnsw_knn_build.py);
    * ``wave``: batched reference-style insertion waves (this module) — the
      same kernel incremental mutation uses.
    """
    n = int(x_device.shape[0]) if x_device is not None else len(
        np.asarray(vectors, dtype=np.float32))
    algo = os.environ.get("VETTORE_HNSW_BUILD") or params.get("build", "auto")
    if algo == "auto":
        algo = "knn" if n >= KNN_BUILD_MIN else "wave"
    if algo == "knn":
        from . import hnsw_knn_build

        return hnsw_knn_build.bulk_build_knn(
            metric, params, ids, vectors=vectors, x_device=x_device)
    if x_device is not None:
        n, d = int(x_device.shape[0]), int(x_device.shape[1])
    else:
        vectors = np.asarray(vectors, dtype=np.float32)
        n, d = vectors.shape
    max_level = params["max_level"]
    m, m0, efc = params["m"], params["m0"], params["ef_construction"]

    ids_sorted, order, levels, lex_rank, lmax, up_index, cap_up = _prep_order(
        ids, max_level, n)

    if x_device is not None:
        xd = x_device[jnp.asarray(order.astype(np.int32))]
    else:
        from ..ops.transport import put_f32_matrix

        xd = put_f32_matrix(vectors[order])
    xt = xd.astype(jnp.bfloat16)  # selection-only traversal block
    a0 = jnp.full((n + 1, m0), -1, jnp.int32)
    up_adj = jnp.full((cap_up + 1, max(lmax, 1), m), -1, jnp.int32)
    up_index_d = jnp.asarray(up_index)
    lex_d = jnp.asarray(lex_rank)
    levels_d = jnp.asarray(levels)

    if beam_steps is None:
        beam_steps = build_step_bound(efc)
    if wave is None:
        # bigger waves amortize dispatch + per-step fixed costs; bounded by
        # the [B, n/32] visited carry and the [B, B] intra-wave peer matrix
        env_wave = os.environ.get("VETTORE_BUILD_WAVE")
        if env_wave:
            wave = int(env_wave)
        elif n >= 2**19:
            wave = 8192  # bigger waves amortize per-wave costs at 1M
        else:
            wave = 4096 if n >= 2**17 else (2048 if n >= 2**14 else 1024)

    import time as _time

    from .hnsw_device import hub_count

    debug = bool(os.environ.get("VETTORE_BUILD_DEBUG"))
    hub_cap = 0 if os.environ.get("VETTORE_BUILD_NO_HUBS") else hub_count(n)
    for start in range(0, n, wave):
        size = min(wave, n - start)
        slots = np.full(wave, 0, dtype=np.int32)
        slots[:size] = np.arange(start, start + size, dtype=np.int32)
        mask = np.zeros(wave, dtype=bool)
        mask[:size] = True
        # insertion order is level-descending, so the wave's top level is its
        # first member's level; selection/reciprocal work is bounded by it.
        # Bucketing to the next power of two caps the number of compiled
        # kernel variants (remote compiles cost minutes each); layers above
        # the wave's true level are fully masked.
        lmax_wave = int(levels[start])
        if lmax_wave > 2:
            b = 4
            while b < lmax_wave:
                b <<= 1
            lmax_wave = min(b, lmax)
        t0 = _time.perf_counter() if debug else 0.0
        a0, up_adj = _wave_step(
            xd, xt, a0, up_adj, up_index_d, lex_d, levels_d,
            jnp.asarray(slots), jnp.asarray(mask), jnp.int32(start),
            jnp.int32(0), jnp.int32(int(levels[0]) if n else 0),
            metric=metric, efc=efc, m=m, m0=m0, lmax=lmax, lmax_wave=lmax_wave,
            beam_steps=beam_steps, hub_cap=hub_cap,
        )
        if debug:
            jax.device_get(a0[0, 0])  # force wave completion
            print(f"[build] wave@{start} size={size} lmax_wave={lmax_wave} "
                  f"{_time.perf_counter() - t0:.2f}s", flush=True)

    # waves dispatch asynchronously; block here so build time is honest and
    # later searches don't silently absorb the construction queue
    jax.block_until_ready((a0, up_adj))

    return BulkGraph(
        ids=ids_sorted, n=n, m=m, m0=m0, lmax=lmax, metric=metric,
        x=xd, a0=a0[:n], up_index=up_index_d, up_adj=up_adj[:cap_up] if cap_up else up_adj[:1],
        lex_rank=lex_d, entry_slot=jnp.int32(0), entry_level=jnp.int32(levels[0] if n else 0),
        levels=levels,
    )


# ---------------------------------------------------------------------------
# incremental mutation of a bulk-built graph
# ---------------------------------------------------------------------------
#
# The reference mutates its graph one record at a time in O(ef·m) per insert
# (hnsw.rs:152-289). The device equivalent keeps the bulk graph device-resident
# and appends through the same ``_wave_step`` kernel that built it:
#
# * device arrays are padded to a CAPACITY beyond ``n`` so per-put shapes
#   stay stable — the wave kernel recompiles only when capacity grows;
# * inserts land in fresh slots and one size-bucketed wave links them
#   (intra-batch candidates via the wave's peer matrix, reciprocal edges via
#   the same segment program as the bulk build);
# * deletes SOFT-delete: the slot's validity bit flips (one device scatter),
#   the node keeps routing traffic through its edges (graph connectivity is
#   preserved — the reference instead rewires, hnsw.rs:263-289) but can never
#   appear in results; compaction rebuilds once tombstones exceed
#   ``REBUILD_FRACTION`` of the graph;
# * lexicographic tie-break ranks are SPACED at build migration so new ids
#   get a rank between their neighbors without renumbering 1M slots; an
#   exhausted gap (≥~1k inserts between two adjacent ids) triggers a full
#   respace.

#: static wave sizes for incremental batches (each bucket is one compiled
#: kernel variant; excess lanes are masked)
INCR_WAVE_BUCKETS = (256, 2048, 8192)

#: slot-capacity growth granularity (bounds recompiles from capacity changes)
GROW_CHUNK = 8192

#: rebuild the graph once tombstones exceed this fraction of slots
REBUILD_FRACTION = 0.25

#: minimum free-slot headroom kept beyond n (tests shrink this to exercise
#: the growth path cheaply)
CAP_SLACK_MIN = 4096


def _round_up(v: int, to: int) -> int:
    return ((v + to - 1) // to) * to


def _capacity(n: int) -> int:
    return _round_up(n + max(CAP_SLACK_MIN, n // 8), min(GROW_CHUNK, max(CAP_SLACK_MIN, 8)))


class _MutState:
    """Host bookkeeping for an incrementally-mutated BulkGraph."""

    __slots__ = ("slot_of", "levels_np", "valid_np", "lex_np", "dead",
                 "sorted_ids", "sorted_ranks", "up_used", "levels_d")


def _ensure_mutable(graph: BulkGraph, valid_np=None) -> _MutState:
    """One-time migration of a frozen bulk graph into mutable form: pads the
    device arrays to capacity, respaces lex ranks, and builds the host-side
    slot/rank maps. O(n log n) host work + one device reallocation; every
    subsequent put/delete is O(batch)."""
    if graph._mut is not None:
        return graph._mut
    n = graph.n
    cap = _capacity(n)
    st = _MutState()
    st.dead = 0

    # ---- lex ranks: respace so ids can insert between neighbors
    lex_np = np.asarray(graph.lex_rank)[:n].astype(np.int64)
    if graph.lex_spacing == 1:
        spacing = max(1, min(1024, (_BIG32 - 2) // max(cap, 1)))
        lex_np = lex_np * spacing
        graph.lex_spacing = spacing
    st.lex_np = np.zeros(cap, np.int64)
    st.lex_np[:n] = lex_np
    ids_np = np.asarray(graph.ids, dtype=str)
    uniq, first = np.unique(ids_np, return_index=True)
    st.sorted_ids = uniq
    st.sorted_ranks = lex_np[first]

    # ---- slot map + levels + validity
    st.valid_np = np.zeros(cap, bool)
    if valid_np is None:
        valid_np = (np.ones(n, bool) if graph.valid is None
                    else np.asarray(graph.valid)[:n])
    st.valid_np[:n] = valid_np
    st.dead = int(n - st.valid_np[:n].sum())
    st.slot_of = {
        id: slot for slot, id in enumerate(graph.ids) if st.valid_np[slot]
    }
    st.levels_np = np.zeros(cap, np.int32)
    st.levels_np[:n] = np.asarray(graph.levels)[:n]
    st.up_used = int((np.asarray(graph.up_index)[:n] >= 0).sum())

    # ---- device capacity padding
    d = graph.x.shape[1]
    pad = cap - graph.x.shape[0]
    if pad > 0:
        graph.x = jnp.concatenate([graph.x, jnp.zeros((pad, d), graph.x.dtype)])
        if graph._xb is not None:
            graph._xb = jnp.concatenate(
                [graph._xb, jnp.zeros((pad, d), graph._xb.dtype)])
    a0_rows = cap + 1 - graph.a0.shape[0]  # +1 trash row for _wave_step
    if a0_rows > 0:
        graph.a0 = jnp.concatenate(
            [graph.a0, jnp.full((a0_rows, graph.m0), -1, jnp.int32)])
    up_cap = st.up_used + max(256, st.up_used // 8) + 1
    up_rows = up_cap - graph.up_adj.shape[0]
    if up_rows > 0:
        graph.up_adj = jnp.concatenate([
            graph.up_adj,
            jnp.full((up_rows,) + graph.up_adj.shape[1:], -1, jnp.int32),
        ])
    idx_pad = cap - graph.up_index.shape[0]
    if idx_pad > 0:
        graph.up_index = jnp.concatenate(
            [graph.up_index, jnp.full(idx_pad, -1, jnp.int32)])
    graph.lex_rank = jnp.asarray(st.lex_np.astype(np.int32))
    st.levels_d = jnp.asarray(st.levels_np)
    if graph.valid is not None or st.dead:
        graph.valid = jnp.asarray(st.valid_np)
    graph.levels = st.levels_np
    graph._hubs = {}
    graph._mut = st
    return st


def _grow_slots(graph: BulkGraph, st: _MutState, need: int) -> None:
    """Grows slot capacity to hold ``need`` slots (device realloc; the wave
    and search kernels recompile once per growth)."""
    cap = _capacity(need)
    pad = cap - graph.x.shape[0]
    if pad <= 0:
        return
    d = graph.x.shape[1]
    graph.x = jnp.concatenate([graph.x, jnp.zeros((pad, d), graph.x.dtype)])
    if graph._xb is not None:
        graph._xb = jnp.concatenate(
            [graph._xb, jnp.zeros((pad, d), graph._xb.dtype)])
    graph.a0 = jnp.concatenate(
        [graph.a0, jnp.full((pad, graph.m0), -1, jnp.int32)])
    graph.up_index = jnp.concatenate(
        [graph.up_index, jnp.full(pad, -1, jnp.int32)])
    graph.lex_rank = jnp.concatenate(
        [graph.lex_rank, jnp.zeros(pad, jnp.int32)])
    st.levels_d = jnp.concatenate([st.levels_d, jnp.zeros(pad, jnp.int32)])
    if graph.valid is not None:
        graph.valid = jnp.concatenate([graph.valid, jnp.zeros(pad, bool)])
    st.lex_np = np.concatenate([st.lex_np, np.zeros(pad, np.int64)])
    st.levels_np = np.concatenate([st.levels_np, np.zeros(pad, np.int32)])
    st.valid_np = np.concatenate([st.valid_np, np.zeros(pad, bool)])
    graph.levels = st.levels_np


def _grow_upper(graph: BulkGraph, st: _MutState, need: int) -> None:
    up_cap = need + max(256, need // 8) + 1
    pad = up_cap - graph.up_adj.shape[0]
    if pad > 0:
        graph.up_adj = jnp.concatenate([
            graph.up_adj,
            jnp.full((pad,) + graph.up_adj.shape[1:], -1, jnp.int32),
        ])


def _grow_layers(graph: BulkGraph, new_lmax: int) -> None:
    add = new_lmax - graph.up_adj.shape[1]
    if add > 0:
        graph.up_adj = jnp.concatenate([
            graph.up_adj,
            jnp.full((graph.up_adj.shape[0], add, graph.m), -1, jnp.int32),
        ], axis=1)
    graph.lmax = max(graph.lmax, new_lmax)


def _assign_lex(st: _MutState, graph: BulkGraph, ids: list) -> np.ndarray:
    """Ranks for a batch of ids: existing ids (replaces/re-inserts) reuse
    their rank; new ids get evenly-spaced ranks inside their lex gap (full
    respace when a gap is exhausted). Returns np.int64 [B]."""
    ids_np = np.array(ids, dtype=str)
    out = np.zeros(len(ids), np.int64)
    ns = len(st.sorted_ids)
    pos = np.searchsorted(st.sorted_ids, ids_np)
    if ns:
        exists = (pos < ns) & (st.sorted_ids[np.minimum(pos, ns - 1)] == ids_np)
        out[exists] = st.sorted_ranks[pos[exists]]
    else:
        exists = np.zeros(len(ids), bool)
    fresh = np.flatnonzero(~exists)
    if not len(fresh):
        return out

    order = fresh[np.argsort(ids_np[fresh], kind="stable")]
    gap_pos = pos[order]
    insert_ids = ids_np[order]
    new_ranks = np.zeros(len(order), np.int64)
    i = 0
    need_respace = False
    while i < len(order):
        j = i
        while j < len(order) and gap_pos[j] == gap_pos[i]:
            j += 1
        k = j - i  # ids landing in this gap
        left = st.sorted_ranks[gap_pos[i] - 1] if gap_pos[i] > 0 else -(
            graph.lex_spacing * (k + 1))
        right = st.sorted_ranks[gap_pos[i]] if gap_pos[i] < ns else (
            left + graph.lex_spacing * (k + 1))
        if right - left <= k:
            need_respace = True
            break
        step = (right - left) / (k + 1)
        new_ranks[i:j] = left + (np.arange(1, k + 1) * step).astype(np.int64)
        i = j
    if insert_ids.dtype.itemsize > st.sorted_ids.dtype.itemsize:
        # widen first: np.insert silently TRUNCATES longer strings to the
        # target array's fixed width
        st.sorted_ids = st.sorted_ids.astype(insert_ids.dtype)
    st.sorted_ids = np.insert(st.sorted_ids, gap_pos, insert_ids)
    st.sorted_ranks = np.insert(st.sorted_ranks, gap_pos, new_ranks)
    if need_respace:
        spacing = max(1, min(1024, (_BIG32 - 2) // max(
            graph.x.shape[0], len(st.sorted_ids))))
        graph.lex_spacing = spacing
        st.sorted_ranks = np.arange(len(st.sorted_ids), dtype=np.int64) * spacing
        _respace_slots(st, graph)
    rank_of = dict(zip(insert_ids.tolist(),
                       st.sorted_ranks[np.searchsorted(
                           st.sorted_ids, insert_ids)].tolist()))
    for idx in fresh:
        out[idx] = rank_of[ids_np[idx]]
    if need_respace:
        # existing ids' ranks moved too — refresh the whole batch
        allpos = np.searchsorted(st.sorted_ids, ids_np)
        out = st.sorted_ranks[allpos]
    return out


def _respace_slots(st: _MutState, graph: BulkGraph) -> None:
    rank_of = dict(zip(st.sorted_ids.tolist(), st.sorted_ranks.tolist()))
    for id, slot in st.slot_of.items():
        st.lex_np[slot] = rank_of[id]
    graph.lex_rank = jnp.asarray(st.lex_np.astype(np.int32))


def _tombstone(graph: BulkGraph, st: _MutState, ids: list) -> int:
    slots = [st.slot_of.pop(i) for i in ids if i in st.slot_of]
    if not slots:
        return 0
    sl = np.asarray(slots, np.int32)
    st.valid_np[sl] = False
    st.dead += len(slots)
    if graph.valid is None:
        graph.valid = jnp.asarray(st.valid_np)
    else:
        graph.valid = graph.valid.at[jnp.asarray(sl)].set(False)
    graph._hubs = {}
    if not st.valid_np[int(graph.entry_slot)]:
        _reelect_entry(graph, st)
    return len(slots)


def _reelect_entry(graph: BulkGraph, st: _MutState) -> None:
    """Deterministic entry re-election: (level desc, id asc) — the soft-
    deleted old entry keeps routing but no longer anchors descent
    (hnsw.rs:263-289 semantics on the live set)."""
    live = st.valid_np[: graph.n]
    if not live.any():
        return
    lv = np.where(live, st.levels_np[: graph.n], -1)
    top = int(lv.max())
    cands = np.flatnonzero(lv == top)
    best = int(cands[np.argmin(st.lex_np[cands])])
    graph.entry_slot = jnp.int32(best)
    graph.entry_level = jnp.int32(top)


def incremental_put(graph: BulkGraph, params: dict, ids: list,
                    vecs: np.ndarray) -> None:
    """Inserts/replaces a batch into a bulk-built graph without host
    hydration. Replace semantics match the reference (existing id → delete
    then insert, hnsw.rs:152-160): the old slot tombstones and the new vector
    takes a fresh slot. Device work is one size-bucketed wave per 8k records;
    host work is O(B log n)."""
    st = _ensure_mutable(graph)
    last = {}
    for i, id in enumerate(ids):
        last[id] = i
    keep = sorted(last.values())
    ids = [ids[i] for i in keep]
    vecs = vecs[keep]
    _tombstone(graph, st, [i for i in ids if i in st.slot_of])

    B = len(ids)
    if not B:
        return
    from .. import native

    max_level = params["max_level"]
    levels = native.levels_batch(ids, max_level)
    if levels is None:
        levels = np.array([level_for(i, max_level) for i in ids], np.int32)
    levels = np.asarray(levels, np.int32)

    if graph.n + B > graph.x.shape[0]:
        _grow_slots(graph, st, graph.n + B)
    batch_lmax = int(levels.max())
    if batch_lmax > graph.up_adj.shape[1]:
        _grow_layers(graph, batch_lmax)
    graph.lmax = max(graph.lmax, batch_lmax)
    n_upper = int((levels >= 1).sum())
    if st.up_used + n_upper + 1 > graph.up_adj.shape[0]:
        _grow_upper(graph, st, st.up_used + n_upper)

    slots = np.arange(graph.n, graph.n + B, dtype=np.int32)
    ranks = _assign_lex(st, graph, ids)
    up_rows = np.full(B, -1, np.int32)
    upb = np.flatnonzero(levels >= 1)
    up_rows[upb] = st.up_used + np.arange(len(upb), dtype=np.int32)
    st.up_used += len(upb)

    for i, id in enumerate(ids):
        st.slot_of[id] = int(slots[i])
    graph.ids.extend(ids)
    st.levels_np[slots] = levels
    st.valid_np[slots] = True
    st.lex_np[slots] = ranks

    sl = jnp.asarray(slots)
    xin = jnp.asarray(np.ascontiguousarray(vecs, dtype=np.float32))
    graph.x = graph.x.at[sl].set(xin)
    if graph._xb is not None:
        graph._xb = graph._xb.at[sl].set(xin.astype(jnp.bfloat16))
    graph.lex_rank = graph.lex_rank.at[sl].set(
        jnp.asarray(ranks.astype(np.int32)))
    graph.up_index = graph.up_index.at[sl].set(jnp.asarray(up_rows))
    st.levels_d = st.levels_d.at[sl].set(jnp.asarray(levels))
    if graph.valid is not None:
        graph.valid = graph.valid.at[sl].set(True)

    # ---- link the new slots through the build kernel
    from .hnsw_device import hub_count

    efc = params["ef_construction"]
    beam_steps = build_step_bound(efc)
    hub_cap = hub_count(graph.x.shape[0])
    xt = graph.xb
    off = 0
    while off < B:
        size = min(B - off, INCR_WAVE_BUCKETS[-1])
        bucket = next(b for b in INCR_WAVE_BUCKETS if b >= size)
        wave_slots = np.zeros(bucket, np.int32)
        wave_slots[:size] = slots[off : off + size]
        mask = np.zeros(bucket, bool)
        mask[:size] = True
        lmax_wave = int(levels[off : off + size].max())
        if lmax_wave > 2:  # bucket compiled variants like bulk_build
            b2 = 4
            while b2 < lmax_wave:
                b2 <<= 1
            lmax_wave = min(b2, graph.lmax)
        graph.a0, graph.up_adj = _wave_step(
            graph.x, xt, graph.a0, graph.up_adj, graph.up_index,
            graph.lex_rank, st.levels_d,
            jnp.asarray(wave_slots), jnp.asarray(mask),
            jnp.int32(graph.n + off), graph.entry_slot, graph.entry_level,
            metric=graph.metric, efc=efc, m=graph.m, m0=graph.m0,
            lmax=graph.lmax, lmax_wave=lmax_wave, beam_steps=beam_steps,
            hub_cap=hub_cap,
        )
        off += size
    graph.n += B
    graph.levels = st.levels_np

    bi = int(np.argmax(levels))
    if int(levels[bi]) > int(graph.entry_level):
        graph.entry_slot = jnp.int32(int(slots[bi]))
        graph.entry_level = jnp.int32(int(levels[bi]))
    graph._hubs = {}


def incremental_delete(graph: BulkGraph, ids: list) -> int:
    """Tombstones ids (device validity-bit flips); returns the number
    removed. The slots keep routing beam traffic (soft delete) but are
    masked out of every result set."""
    st = _ensure_mutable(graph)
    return _tombstone(graph, st, [str(i) for i in ids])


def should_compact(graph: BulkGraph) -> bool:
    st = graph._mut
    if st is None or not st.dead:
        return False
    return st.dead > max(64, REBUILD_FRACTION * graph.n)


def compact(graph: BulkGraph, params: dict):
    """Rebuilds the graph from its live slots (device-resident gather, no
    host round-trip). Returns the fresh BulkGraph, or None when no live
    records remain."""
    st = _ensure_mutable(graph)
    live_slots = np.flatnonzero(st.valid_np[: graph.n])
    if not len(live_slots):
        return None
    ids_live = [graph.ids[s] for s in live_slots]
    x_live = graph.x[jnp.asarray(live_slots.astype(np.int32))]
    return bulk_build(graph.metric, params, ids_live, x_device=x_live)
