"""Mesh-sharded IVF: per-shard k-means routing blocks, interconnect candidate merge.

The IVF index (index/ivf.py) sharded by rows across the ``shard`` axis of a
device mesh (SURVEY §5.8 posture, same scatter-gather shape as
hnsw_mesh.ShardedHnsw): each shard holds a cluster-major block of its row
range plus that block's routing centroids; a query under ``shard_map`` routes
to its best ``n_probe`` blocks per shard, rescores those rows, and the
per-shard top-k candidate triples (rank, global lex, global row) merge over
the interconnect with a multi-key sort — the deterministic (rank, id) tie-break survives
end to end. Probing P blocks on each of S shards examines S·P blocks total,
so per-shard recall at fixed ``n_probe`` is at least single-chip recall.

The in-shard-map rescore is the portable XLA formulation (gather + einsum
at full f32 precision, so the shard selects exactly as one device does) — it
runs identically on the virtual CPU mesh and on real devices.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..errors import UnsupportedIvfMetric
from ..index.base import Index
from ..index.flat import FlatIndex
from ..index.ivf import IVF_METRICS, validate_options
from ..metrics import normalize_metric
from ..ops import ivf as ops_ivf
from ..ops.flat_scan import GROUP
from .mesh import program_cache

_BIG32 = 2**31 - 1


class ShardedIvf:
    """IVF structure sharded across the ``shard`` axis of a device mesh."""

    def __init__(self, metric: str, mesh: Mesh, ids, vectors, *, options=None):
        metric = normalize_metric(metric)
        if metric not in IVF_METRICS:
            raise UnsupportedIvfMetric(metric)
        self.metric = metric
        self.params = validate_options(options)
        self.mesh = mesh
        shards = mesh.shape["shard"]
        vectors = np.asarray(vectors, dtype=np.float32)
        n, d = vectors.shape
        if len(ids) != n:
            raise ValueError("ids/vectors length mismatch")

        # global lex ranks (ids arrive in caller order; the merge needs the
        # id-sorted rank like every other sharded index here)
        order = np.argsort(np.array([str(i) for i in ids], dtype=str), kind="stable")
        global_lex = np.zeros(n, dtype=np.int32)
        global_lex[order] = np.arange(n, dtype=np.int32)

        per = max(GROUP, math.ceil(n / shards))
        capb = -(-per // GROUP) * GROUP
        ngb = capb // GROUP
        xs = np.zeros((shards, capb, d), np.float32)
        xsq = np.zeros((shards, capb), np.float32)
        bias = np.full((shards, capb), np.inf, np.float32)
        lex = np.full((shards, capb), _BIG32, np.int32)
        rows = np.full((shards, capb), -1, np.int32)
        bcb = np.zeros((shards, ngb, d), np.float32)
        csq = np.zeros((shards, ngb), np.float32)
        bbias = np.full((shards, ngb), np.inf, np.float32)

        for s in range(shards):
            lo, hi = s * per, min((s + 1) * per, n)
            cnt = hi - lo
            if cnt <= 0:
                continue
            block = np.zeros((capb, d), np.float32)
            block[:cnt] = vectors[lo:hi]
            valid = np.zeros(capb, bool)
            valid[:cnt] = True
            # per-shard k-means layout on the default device (build-time
            # only; the resident sharded copies are placed below)
            xdev = jnp.asarray(block)
            vdev = jnp.asarray(valid)
            assign = ops_ivf.kmeans_assign(
                xdev, vdev, n_cent=ngb, iters=self.params["kmeans_iters"],
                metric=metric)
            perm = np.asarray(jnp.argsort(assign, stable=True))
            xs[s] = block[perm]
            valid_sorted = valid[perm]
            b_cent, b_csq, b_bias, b_xsq, b_rowbias = jax.device_get(
                ops_ivf.build_blocks(jnp.asarray(xs[s]),
                                     jnp.asarray(valid_sorted), metric=metric))
            bcb[s] = np.asarray(b_cent, np.float32)
            csq[s] = b_csq
            bbias[s] = b_bias
            xsq[s] = b_xsq
            bias[s] = b_rowbias
            src = lo + perm  # block slot -> global row (pads map past hi)
            ok = valid_sorted
            rows[s] = np.where(ok, src, -1)
            lex[s] = np.where(ok, global_lex[np.minimum(src, n - 1)], _BIG32)

        self.ids = [str(i) for i in ids]
        self.n = n
        self.d = d
        self.capb = capb
        row_spec = NamedSharding(mesh, P("shard", None, None))
        flag_spec = NamedSharding(mesh, P("shard", None))
        self._x = jax.device_put(xs.astype(
            np.float32 if self.params["storage"] == "f32" else
            _bf16_np()), row_spec)
        self._xsq = jax.device_put(xsq, flag_spec)
        self._bias = jax.device_put(bias, flag_spec)
        self._lex = jax.device_put(lex, flag_spec)
        self._rows = jax.device_put(rows, flag_spec)
        self._bcb = jax.device_put(bcb.astype(_bf16_np()), row_spec)
        self._csq = jax.device_put(csq, flag_spec)
        self._bbias = jax.device_put(bbias, flag_spec)
        self._bias_host = bias  # for cheap delete masking
        self._rows_host = rows
        #: {"n_probe", "recall_at_10", "target"} after an auto-tune build
        self.tuned: dict | None = None
        if self.params["n_probe"] == "auto":
            self._tune_n_probe(vectors)

    def _tune_n_probe(self, vectors: np.ndarray) -> None:
        """``n_probe="auto"`` (index/ivf.py:_tune_n_probe, sharded): smallest
        probe count whose recall@10 on a held-out row sample meets
        ``target_recall``; ground truth probes every block (exact by the
        n_probe >= n_blocks contract, ops/ivf.py)."""
        sample = min(64, self.n)
        pick = np.linspace(0, self.n - 1, sample).astype(np.int64)
        queries = vectors[pick]
        k = min(10, self.n)
        ngb = self.capb // GROUP
        truth = [{id for id, _ in row}
                 for row in self._probe_batch(queries, k, ngb)]
        target = self.params["target_recall"]
        chosen, recall = None, 0.0
        for p in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
            if chosen is not None and p > ngb:
                break
            got = self._probe_batch(queries, k, min(p, ngb))
            recall = float(np.mean([
                len({id for id, _ in row} & want) / max(len(want), 1)
                for row, want in zip(got, truth)]))
            chosen = min(p, ngb)
            if recall >= target or p >= ngb:
                break
        self.tuned = {"n_probe": chosen, "recall_at_10": round(recall, 4),
                      "target": target}

    def effective_n_probe(self) -> int:
        """The probe count searches actually use (auto resolves at build)."""
        p = self.params["n_probe"]
        if p == "auto":
            return self.tuned["n_probe"] if self.tuned else 8
        return p

    def invalidate_rows(self, global_rows) -> None:
        """Masks global rows out of results (delete without rebuild)."""
        targets = set(int(r) for r in global_rows)
        changed = False
        for s in range(self._rows_host.shape[0]):
            hit = np.isin(self._rows_host[s], list(targets))
            if hit.any():
                self._bias_host[s, hit] = np.inf
                changed = True
        if changed:
            self._bias = jax.device_put(
                self._bias_host, NamedSharding(self.mesh, P("shard", None)))

    def search_batch(self, queries, limit: int) -> list:
        ngb = self.capb // GROUP
        return self._probe_batch(queries, limit,
                                 min(self.effective_n_probe(), ngb))

    def _probe_batch(self, queries, limit: int, nprobe: int) -> list:
        queries = np.asarray(queries, dtype=np.float32)
        b = queries.shape[0]
        dp = self.mesh.shape["data"]
        pad_b = max(dp, math.ceil(b / dp) * dp)
        padded = np.zeros((pad_b, self.d), np.float32)
        padded[:b] = queries
        q = jax.device_put(padded, NamedSharding(self.mesh, P("data", None)))
        k = min(limit, max(self.n, 1))
        rows, raws = jax.device_get(_sharded_ivf_search(
            self.mesh, self._x, self._xsq, self._bias, self._lex, self._rows,
            self._bcb, self._csq, self._bbias, q,
            metric=self.metric, nprobe=nprobe, k=k))
        out = []
        for row in range(b):
            hits = []
            for gr, raw in zip(rows[row], raws[row]):
                if gr < 0:
                    continue
                hits.append((self.ids[int(gr)], float(raw)))
            out.append(hits[:limit])
        return out


def _bf16_np():
    import ml_dtypes

    return ml_dtypes.bfloat16


def _sharded_ivf_search(mesh, x, xsq, bias, lex, rows, bcb, csq, bbias,
                        queries, *, metric, nprobe, k):
    return _ivf_search_program(mesh, metric, nprobe, k)(
        x, xsq, bias, lex, rows, bcb, csq, bbias, queries)


@program_cache
def _ivf_search_program(mesh, metric, nprobe, k):
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P("shard", None, None), P("shard", None), P("shard", None),
            P("shard", None), P("shard", None), P("shard", None, None),
            P("shard", None), P("shard", None), P("data", None),
        ),
        out_specs=(P("data", None), P("data", None)),
        check_vma=False,
    )
    def step(x_b, xsq_b, bias_b, lex_b, rows_b, bcb_b, csq_b, bbias_b, q_b):
        xs = x_b[0]
        capb, d = xs.shape
        ngb = capb // GROUP
        qf = q_b.astype(jnp.float32)
        # selection-only (block routing): bf16 operands, f32 accumulation
        dots = jnp.dot(qf.astype(jnp.bfloat16), bcb_b[0].T,
                       preferred_element_type=jnp.float32)  # [b, ngb]
        if metric in ("cosine", "inner_product"):
            crank = -dots
        elif metric == "negative_inner_product":
            crank = dots
        else:
            crank = csq_b[0][None, :] - 2.0 * dots
        crank = crank + bbias_b[0][None, :]
        _v, gidx = jax.lax.top_k(-crank, nprobe)
        gidx = jnp.minimum(gidx, ngb - 1)  # [b, p]

        xg = xs.reshape(ngb, GROUP, d)
        cand_rows = xg[gidx]  # [b, p, GROUP, d]
        cdots = jnp.einsum("bpgd,bd->bpg", cand_rows.astype(jnp.float32), qf,
                           precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)
        if metric in ("cosine", "inner_product"):
            crk = -cdots
        elif metric == "negative_inner_product":
            crk = cdots
        else:
            cxsq = xsq_b[0].reshape(ngb, GROUP)[gidx]
            qsq = jnp.sum(qf * qf, axis=1)[:, None, None]
            crk = cxsq - 2.0 * cdots + qsq
        cbias = bias_b[0].reshape(ngb, GROUP)[gidx]
        crk = (crk + cbias).reshape(qf.shape[0], -1)  # [b, p*GROUP]
        slots = (gidx[:, :, None] * GROUP
                 + jnp.arange(GROUP, dtype=jnp.int32)[None, None, :]).reshape(
            qf.shape[0], -1)
        clex = jnp.where(jnp.isfinite(crk),
                         lex_b[0][slots], _BIG32)
        kk = min(k, crk.shape[1])
        rank_s, lex_s, slot_s = jax.lax.sort((crk, clex, slots), num_keys=2,
                                             dimension=1)
        rank_s, lex_s, slot_s = rank_s[:, :kk], lex_s[:, :kk], slot_s[:, :kk]
        if kk < k:
            pad = k - kk
            rank_s = jnp.pad(rank_s, ((0, 0), (0, pad)), constant_values=jnp.inf)
            lex_s = jnp.pad(lex_s, ((0, 0), (0, pad)), constant_values=_BIG32)
            slot_s = jnp.pad(slot_s, ((0, 0), (0, pad)), constant_values=0)
        grows = jnp.where(jnp.isfinite(rank_s),
                          rows_b[0][slot_s], -1)
        # raws of the local winners at HIGHEST precision (flat _finalize
        # posture): gather k rows per query
        win_rows = xs[slot_s].astype(jnp.float32)  # [b, k, d]
        if metric in ("l2", "l2_squared"):
            diff = win_rows - qf[:, None, :]
            sq = jnp.sum(diff * diff, axis=-1)
            raw = jnp.sqrt(sq) if metric == "l2" else sq
            rank_m = jnp.where(jnp.isfinite(rank_s), raw, jnp.inf)
        else:
            rdots = jnp.einsum("bkd,bd->bk", win_rows, qf,
                               precision=jax.lax.Precision.HIGHEST,
                               preferred_element_type=jnp.float32)
            raw = -rdots if metric == "negative_inner_product" else rdots
            rank_m = jnp.where(jnp.isfinite(rank_s),
                               (1.0 - raw) if metric == "cosine" else
                               (-raw if metric == "inner_product" else raw),
                               jnp.inf)
        # merge candidate triples over the interconnect, exactly as the flat/hnsw meshes
        d_all = jax.lax.all_gather(rank_m, "shard", axis=1, tiled=True)
        l_all = jax.lax.all_gather(lex_s, "shard", axis=1, tiled=True)
        r_all = jax.lax.all_gather(grows, "shard", axis=1, tiled=True)
        w_all = jax.lax.all_gather(raw, "shard", axis=1, tiled=True)
        dm, _, rm, wm = jax.lax.sort((d_all, l_all, r_all, w_all), num_keys=2,
                                     dimension=1)
        top_rows = jnp.where(jnp.isfinite(dm[:, :k]), rm[:, :k], -1)
        return top_rows, wm[:, :k]

    return step


class MeshIvfIndex(Index):
    """IVF sharded over a device mesh, wrapped in the Index behaviour
    (lib/vettore/index.ex:12-17): host mirror for validation/canonical rows,
    full (seconds-cheap) relayout on inserts, device mask flips on delete."""

    def __init__(self, metric: str, options=None, *, mesh):
        metric = normalize_metric(metric)
        if metric not in IVF_METRICS:
            raise UnsupportedIvfMetric(metric)
        self.metric = metric
        self.params = validate_options(options)
        self.mesh = mesh
        self._host = FlatIndex(metric)
        self._sharded: ShardedIvf | None = None
        self._built_version = -1
        self._version = 0
        self._built_row_of: dict = {}  # id -> global row in the built layout

    def __len__(self):
        return len(self._host)

    @property
    def dimension(self):
        return self._host.dimension

    @property
    def _slot_of(self):
        return self._host._slot_of

    def put(self, id: str, vector) -> None:
        self.put_many([(id, vector)])

    def put_many(self, pairs) -> None:
        self._host.put_many(pairs)
        self._version += 1

    def put_matrix(self, ids, matrix) -> None:
        self._host.put_matrix(ids, matrix)
        self._version += 1

    def delete(self, id: str) -> None:
        existed = id in self._host._slot_of
        self._host.delete(id)
        if not existed:
            return
        if self._sharded is not None and self._built_version == self._version:
            row = self._built_row_of.get(str(id))
            if row is not None:
                self._sharded.invalidate_rows([row])
            self._version += 1
            self._built_version = self._version
        else:
            self._version += 1

    def _sync(self):
        if self._sharded is not None and self._built_version == self._version:
            return
        host = self._host
        if host._host_x is None or not host._slot_of:
            self._sharded = None
            self._built_version = self._version
            self._built_row_of = {}
            return
        live = sorted(host._slot_of)
        rows = np.stack([host._host_x[host._slot_of[id]] for id in live])
        self._sharded = ShardedIvf(self.metric, self.mesh, live, rows,
                                   options=self.params)
        self._built_row_of = {id: i for i, id in enumerate(live)}
        self._built_version = self._version

    def search(self, query, limit: int) -> list:
        return self.search_batch(np.asarray(query, np.float32)[None, :], limit)[0]

    def search_batch(self, queries, limit: int) -> list:
        if limit == 0:
            return [[] for _ in range(len(queries))]
        self._sync()
        if self._sharded is None:
            return [[] for _ in range(len(queries))]
        return self._sharded.search_batch(queries, limit)
