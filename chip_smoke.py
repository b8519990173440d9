"""On-card smoke check: vettore's search path at full width on NVIDIA GPUs.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py               # one card: every single-card phase
    python chip_smoke.py --devices 4   # four cards: the mesh phases only
    python chip_smoke.py --only flat,ivf          # a subset (for iterating)
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse   # tiny CPU dry run

The one-card run drives the main path — ``Collection(index="flat",
metric="cosine")`` over 1,000,000 x 768 rows in f32 and bf16 storage,
``put_matrix`` ingest, ``search_batch`` at batch 512 and ``search`` with one
query — and checks every answer against a float64 numpy scan of the same
rows. It times the flat step's pass-1 routes (the Pallas Triton group-min
kernel and XLA's plain matmul) inside ``fused_flat_search``, runs every
other search mode against its own reference, and runs the ``gpu``-marked
tests in this process. Data are random, made from ``--seed``.

Every phase prints its seconds, compilation included. No failure is
caught: any failed check exits non-zero. Without a GPU the script exits
non-zero before it prints a result. The last line of a passing run is one
JSON object, ``{"ok": true, "device": {"platform", "kind", "count"}}``.
``--rehearse`` runs the phases at a tiny size on any platform, prints no
result line and exits 3.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

SINGLE_PHASES = ("flat", "kernel_timing", "funnel_quantized", "ivf", "hnsw",
                 "flat_small", "maxsim", "pytest")
MESH_PHASES = ("mesh",)

#: full-size shapes (BASELINE.json configs) and the rehearsal's tiny ones
FULL = dict(n=1_000_000, d=768, batch=512, timing_batches=(64, 512), reps=20,
            hnsw_n=200_000, small_n=100_000, small_d=384, mv_n=100_000,
            mv_t=32, mv_d=128, mv_q=16, mesh_small_n=65_536, mesh_mv_n=8192)
TINY = dict(n=4096, d=384, batch=16, timing_batches=(4, 16), reps=2,
            hnsw_n=4096, small_n=2048, small_d=384, mv_n=1024,
            mv_t=8, mv_d=128, mv_q=4, mesh_small_n=2048, mesh_mv_n=512)


@contextlib.contextmanager
def phase(name):
    print(f"[phase] {name}: start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def log(msg):
    print(f"  {msg}", flush=True)


def require(cond, msg="check failed"):
    """A check that holds under ``python -O`` too (``assert`` would not)."""
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# data and references
# ---------------------------------------------------------------------------


def clustered(n, d, rng, spread=0.4, chunk=131_072):
    """Unit rows in Gaussian clusters (n/100 centers, radius ``spread``):
    embedding-like geometry, f32, never bf16-exact."""
    k = max(16, n // 100)
    centers = rng.standard_normal((k, d), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    out = np.empty((n, d), np.float32)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        blk = rng.standard_normal((m, d), dtype=np.float32)
        blk *= spread / np.sqrt(d)
        blk += centers[rng.integers(0, k, m)]
        blk /= np.linalg.norm(blk, axis=1, keepdims=True)
        out[s:s + m] = blk
    return out


def near(rows, b, rng, spread=0.4):
    """``b`` queries: perturbed copies of random rows, unit norm."""
    q = rows[rng.integers(0, len(rows), b)].astype(np.float32)
    q = q + rng.standard_normal(q.shape, dtype=np.float32) * (spread / np.sqrt(q.shape[1]))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def exact_top(rows, q, k, chunk=131_072):
    """float64 top-``k`` by descending dot, ties by row index: ``(idx [B, k],
    scores [B, k])`` over any-dtype host rows, chunk by chunk."""
    qd = np.asarray(q, np.float64)
    keep_i, keep_s = [], []
    for s in range(0, len(rows), chunk):
        sc = qd @ np.asarray(rows[s:s + chunk], np.float64).T
        kk = min(k, sc.shape[1])
        part = np.argpartition(-sc, kk - 1, axis=1)[:, :kk]
        keep_i.append(part + s)
        keep_s.append(np.take_along_axis(sc, part, axis=1))
    idx, sc = np.concatenate(keep_i, axis=1), np.concatenate(keep_s, axis=1)
    order = np.lexsort((idx, -sc), axis=1)[:, :k]
    return np.take_along_axis(idx, order, axis=1), np.take_along_axis(sc, order, axis=1)


def dots_of(rows, q, idx):
    """float64 dot of each query with its listed rows: ``[B, k]``."""
    return np.einsum("bkd,bd->bk", np.asarray(rows[idx], np.float64),
                     np.asarray(q, np.float64))


def hit_ids(results, prefix_len=1):
    return [[int(r.id[prefix_len:]) for r in row] for row in results]


def overlap(got, want, k=10):
    return float(np.mean([len(set(g[:k]) & set(w[:k])) / k for g, w in zip(got, want)]))


def check_exact(name, got_ids, got_scores, rows, q, ref_scores, tie=1e-6, tol=1e-4):
    """Ids match the reference rank by rank, except where the reference's own
    scores at that rank sit within ``tie`` of the returned row's exact score
    (a tie the order may resolve either way); every returned score is within
    ``tol`` of its float64 value."""
    got_ids = np.asarray(got_ids)
    exact = dots_of(rows, q, got_ids)
    k = got_ids.shape[1]
    gap = np.max(np.abs(exact - ref_scores[:, :k]))
    require(gap <= tie, f"{name}: ids differ from the reference beyond ties "
                        f"(max gap {gap:.3g})")
    err = np.max(np.abs(np.asarray(got_scores) - exact))
    require(err <= tol, f"{name}: score error {err:.3g} > {tol}")
    log(f"{name}: {got_ids.shape[0]} queries exact; max score error {err:.3g}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


class Ctx:
    """State shared between phases (the 1M corpus and its collections)."""


def no_host_fallback(index):
    """Counts calls of the flat index's float64 host oracle — a device path
    that defers to it must not pass as correct."""
    calls = []
    orig = index._host_search
    index._host_search = lambda q, limit: calls.append(1) or orig(q, limit)
    return calls


def flat_main(ctx, sz, rng, jax, jnp, vt):
    from vettore_tpu.ops import flat_scan

    n, d, b = sz["n"], sz["d"], sz["batch"]
    with phase("data"):
        ctx.data = clustered(n, d, rng)
        ctx.ids = [f"d{i:07d}" for i in range(n)]
        ctx.queries = near(ctx.data, b, rng)
    ctx.flat = {}
    for storage in ("f32", "bf16"):
        with phase(f"flat_{storage}_ingest"):
            col = vt.Collection(name=f"flat-{storage}", dimensions=d,
                                metric="cosine", index="flat",
                                compressed=storage == "bf16")
            col.put_matrix(ctx.ids, ctx.data)
            col.index._sync_device()  # the upload, outside the search timing
            col.sync()
        idx = col.index
        calls = no_host_fallback(idx)
        rows = idx._host_x[:n]  # the rows the device block holds
        prepared = col._prepare_query_batch(ctx.queries).astype(np.float32)
        with phase(f"flat_{storage}_reference"):
            ref_ids, ref_sc = exact_top(rows, prepared, 11)
            log(f"reference gap at rank 10 < 1e-6 for "
                f"{int(np.sum(ref_sc[:, 9] - ref_sc[:, 10] < 1e-6))} of {b} queries")
        with phase(f"flat_{storage}_search_batch_{b}"):
            res = col.search_batch(ctx.queries, limit=10)
        with phase(f"flat_{storage}_search_1"):
            one = col.search(ctx.queries[0], limit=10)
        got = hit_ids(res)
        scores = [[r.score for r in row] for row in res]
        require([r.id for r in one] == [r.id for r in res[0]], "search != search_batch[0]")
        require(all(len(row) == 10 for row in got))
        if storage == "f32":
            check_exact("flat f32", got, scores, rows, prepared, ref_sc)
        else:
            ov = overlap(got, ref_ids)
            err = np.max(np.abs(np.asarray(scores) - dots_of(rows, prepared, np.asarray(got))))
            log(f"flat bf16: overlap@10 {ov:.4f} vs float64 scan of the stored "
                f"bf16 rows; max score error {err:.3g}")
            require(ov >= 0.99 and err <= 1e-4, (ov, err))
            f32_ids, _ = exact_top(ctx.data, prepared, 10)
            log(f"flat bf16: overlap@10 {overlap(got, f32_ids):.4f} vs the f32 rows (info)")
        # the device path's own flag, for the whole batch and for one query
        k = 16
        require(idx._fused_eligible(k))
        for qb in (prepared, prepared[:1]):
            _s, _r, _rk, ok = idx._fused_dispatch(jnp.asarray(qb), k)
            require(bool(ok), f"flat {storage}: device ok flag is False")
        require(not calls, f"flat {storage}: {len(calls)} queries fell back to the host")
        x = idx._device[0]
        route = flat_scan.pass1_impl(jax.default_backend(), x.dtype, *x.shape)
        log(f"flat {storage}: pass-1 route {route}")
        if jax.default_backend() == "gpu":
            require(route == ("triton" if storage == "bf16" else "xla"), route)
            xsq, bias, lex_rank = idx._device_scan
            hlo = flat_scan.fused_flat_search.lower(
                x, xsq, bias, lex_rank, jnp.asarray(prepared), metric="cosine",
                k=k).compile().as_text()
            require(("flat_gmin_scan" in hlo) == (route == "triton"), "route not compiled in")
        ctx.flat[storage] = (col, prepared, ref_ids, ref_sc)


def kernel_timing(ctx, sz, jax, jnp, interpret):
    """Pass-1 routes inside the whole fused_flat_search call, per storage and
    batch: median of ``reps`` runs, each ended by block_until_ready."""
    from vettore_tpu.ops import flat_scan

    for storage in ("bf16", "f32"):
        col = ctx.flat[storage][0]
        x, _valid, _lex = col.index._device
        xsq, bias, lex_rank = col.index._device_scan
        for b in sz["timing_batches"]:
            q = jnp.asarray(near(ctx.data, b, np.random.default_rng(b)))
            times = {}
            for impl in ("triton", "xla"):
                t0 = time.perf_counter()
                fn = flat_scan.fused_flat_search.lower(
                    x, xsq, bias, lex_rank, q, metric="cosine", k=16, impl=impl,
                    interpret=interpret and impl == "triton").compile()
                compile_s = time.perf_counter() - t0
                jax.block_until_ready(fn(x, xsq, bias, lex_rank, q))
                reps = []
                for _ in range(sz["reps"]):
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn(x, xsq, bias, lex_rank, q))
                    reps.append(time.perf_counter() - t0)
                times[impl] = float(np.median(reps)) * 1e3
                log(f"flat_step storage={storage} batch={b} impl={impl}: "
                    f"median {times[impl]:.3f} ms min {min(reps) * 1e3:.3f} ms "
                    f"(compile {compile_s:.1f} s)")
                if b == max(sz["timing_batches"]):
                    log(f"  memory_analysis: {fn.memory_analysis()}")
            chosen = flat_scan.pass1_impl(jax.default_backend(), x.dtype, *x.shape)
            faster = min(times, key=times.get)
            log(f"flat_step storage={storage} batch={b}: faster {faster}, "
                f"route taken {chosen}")
        if storage == "bf16":
            b = max(sz["timing_batches"])
            q = jnp.asarray(near(ctx.data, b, np.random.default_rng(1)))
            p1 = jax.jit(lambda x, xsq, bias, q: flat_scan._gmin_scan(
                x, xsq, bias, q, metric="cosine", interpret=interpret))
            jax.block_until_ready(p1(x, xsq, bias, q))
            reps = []
            for _ in range(sz["reps"]):
                t0 = time.perf_counter()
                jax.block_until_ready(p1(x, xsq, bias, q))
                reps.append(time.perf_counter() - t0)
            log(f"flat_step storage=bf16 batch={b}: pass-1 kernel alone median "
                f"{np.median(reps) * 1e3:.3f} ms")


def funnel_quantized(ctx, sz, rng, jnp):
    col, prepared, ref_ids, _ = ctx.flat["f32"]
    rows = col.index._host_x[: sz["n"]]
    qn = min(64, len(prepared))
    q = prepared[:qn]
    with phase("funnel_128_256_384_c200"):
        got = hit_ids(col.funnel_search_batch(ctx.queries[:qn], limit=10,
                                              candidates=200, stages=[128, 256, 384]))
        # reference semantics: top-200 by prefix-128 true cosine, then the
        # later stages only reorder the same 200; full-width cosine picks 10
        pre = rows[:, :128]
        qp = q[:, :128].astype(np.float64)
        norms = np.linalg.norm(np.asarray(pre, np.float64), axis=1)
        cand, _ = exact_top(pre / np.maximum(norms, 1e-30)[:, None],
                            qp / np.linalg.norm(qp, axis=1, keepdims=True), 200)
        full = dots_of(rows, q, cand)
        order = np.lexsort((cand, -full), axis=1)[:, :10]
        wsc = np.take_along_axis(full, order, axis=1)
        # ids checked rank by rank (scores are the mode's true cosine, which
        # the returned-score check below does not cover: tol=1)
        check_exact("funnel", got, dots_of(rows, q, np.asarray(got)), rows, q, wsc, tol=1)
        log(f"funnel: overlap@10 vs exact scan {overlap(got, ref_ids):.4f} (info)")
    with phase("quantized_c500"):
        got = hit_ids(col.quantized_search_batch(ctx.queries[:qn], limit=10,
                                                 candidates=500))
        signs = np.where(np.asarray(rows) >= 0, 1.0, -1.0).astype(np.float32)
        qs = np.where(q >= 0, 1.0, -1.0).astype(np.float32)
        ham = (sz["d"] - qs @ signs.T) / 2  # exact small integers in f32
        cand = np.argsort(ham, axis=1, kind="stable")[:, :500]
        full = dots_of(rows, q, cand)
        order = np.lexsort((cand, -full), axis=1)[:, :10]
        wsc = np.take_along_axis(full, order, axis=1)
        check_exact("quantized", got, dots_of(rows, q, np.asarray(got)), rows, q, wsc, tol=1)
        log(f"quantized: overlap@10 vs exact scan {overlap(got, ref_ids):.4f} (info)")


def ivf(ctx, sz, vt):
    from vettore_tpu.index.ivf import IvfIndex

    col, prepared, ref_ids, _ = ctx.flat["bf16"]
    with phase("ivf_build_auto"):
        index = IvfIndex.from_flat(col.index, {"n_probe": "auto"})
        index.rebuild()
        col.attach_index(index)
        log(f"ivf: n_probe resolved to {index.effective_n_probe()} "
            f"({index.tuned})")
    with phase("ivf_search_batch"):
        got = hit_ids(col.search_batch(ctx.queries, limit=10))
    r = overlap(got, ref_ids)
    log(f"ivf: recall@10 {r:.4f} vs the exact scan")
    require(r >= 0.9, r)


def hnsw(ctx, sz, rng, vt):
    # its own corpus at the same cluster density as the 1M one (n/100
    # centers): a prefix of the 1M corpus would hold 20 rows per cluster
    n = sz["hnsw_n"]
    rows = clustered(n, sz["d"], rng)
    opts = {"m": 16, "m0": 32, "ef_construction": 100, "ef_search": 64,
            "build": "knn"}
    with phase(f"hnsw_knn_build_{n}"):
        col = vt.Collection(name="hnsw", dimensions=sz["d"], metric="cosine",
                            index="hnsw", index_options=opts)
        col.put_matrix(ctx.ids[:n], rows)
        col.sync()
    q = near(rows, 256, rng)
    with phase("hnsw_search_batch"):
        got = hit_ids(col.search_batch(q, limit=10))
    prepared = col._prepare_query_batch(q)
    want, _ = exact_top(rows, prepared, 10)
    r = overlap(got, want)
    log(f"hnsw: recall@10 {r:.4f}")
    require(r >= 0.95, r)
    col.close()


def flat_small(sz, rng, vt):
    n, d = sz["small_n"], sz["small_d"]
    data = clustered(n, d, rng)
    ids = [f"s{i:07d}" for i in range(n)]
    q = near(data, 256, rng)
    with phase(f"flat_small_{n}x{d}"):
        col = vt.Collection(name="small", dimensions=d, metric="cosine", index="flat")
        col.put_matrix(ids, data)
        calls = no_host_fallback(col.index)
        prepared = col._prepare_query_batch(q).astype(np.float32)
        res = col.search_batch(q, limit=10)
        rows = col.index._host_x[:n]
        _, ref_sc = exact_top(rows, prepared, 10)
        check_exact("flat small", hit_ids(res), [[r.score for r in row] for row in res],
                    rows, prepared, ref_sc)
    with phase("insert_delete_search"):
        top = [row[0].id for row in res[:8]]
        for hid in top:
            col.delete(hid)
        fresh = near(data, 8, rng)
        col.put_many([{"id": f"z{i}", "vector": v} for i, v in enumerate(fresh)])
        res2 = col.search_batch(fresh, limit=3)
        require([row[0].id for row in res2] == [f"z{i}" for i in range(8)])
        res3 = col.search_batch(q[:8], limit=10)
        require(not ({r.id for row in res3 for r in row} & set(top)))
        require(not calls)
    with phase("snapshot_roundtrip"), tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "small.vsnap")
        col.snapshot(path)
        loaded = vt.load_snapshot(path)
        a = [[(r.id, r.score) for r in row] for row in col.search_batch(q[:32], limit=10)]
        b = [[(r.id, r.score) for r in row] for row in loaded.search_batch(q[:32], limit=10)]
        require(a == b)
        require(loaded.count() == col.count())
        loaded.close()
    col.close()


def mv_reference(tokens, qset, docs):
    """float64 MaxSim (cosine over unit tokens) of one query set against
    the listed docs."""
    c, t, d = len(docs), tokens.shape[1], tokens.shape[2]
    flat = np.asarray(tokens[docs], np.float64).reshape(c * t, d)
    sim = (flat @ np.asarray(qset, np.float64).T).reshape(c, t, -1)  # [C, T, Q]
    return sim.max(axis=1).sum(axis=1)


def mv_top(tokens, qset, k, chunk=8192):
    scores = np.concatenate([
        mv_reference(tokens, qset, np.arange(s, min(s + chunk, len(tokens))))
        for s in range(0, len(tokens), chunk)])
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return order, scores[order]


def maxsim_modes(sz, rng, vt, jnp):
    from vettore_tpu.ops.mmr import mmr_rerank, mmr_rerank_batch

    n, t, d, nq = sz["mv_n"], sz["mv_t"], sz["mv_d"], sz["mv_q"]
    with phase(f"maxsim_ingest_{n}x{t}x{d}"):
        centers = clustered(n, d, rng)
        tokens = centers[:, None, :] + rng.standard_normal((n, t, d), dtype=np.float32) * (
            1.0 / np.sqrt(d))
        tokens /= np.linalg.norm(tokens, axis=2, keepdims=True)
        col = vt.Collection(name="mv", dimensions=d, metric="cosine", index="flat")
        col.put_tokens([f"m{i:07d}" for i in range(n)], tokens)
        stored = np.stack([r.vectors for r in col._scan_cache().records])
        src = rng.integers(0, n, nq)
        qsets = [stored[i] + rng.standard_normal((t, d), dtype=np.float32) * 0.05
                 for i in src]
        qsets = [qs / np.linalg.norm(qs, axis=1, keepdims=True) for qs in qsets]
    with phase("maxsim_exact_batch"):
        res = col.multi_vector_search_batch([qs.tolist() for qs in qsets], limit=10)
    prepared = [col._prepare_query_vectors(qs.tolist()) for qs in qsets]
    want = [mv_top(stored, p, 11) for p in prepared]
    for row, (wid, wsc), p in zip(res, want, prepared):
        got = np.asarray([int(r.id[1:]) for r in row])
        exact = mv_reference(stored, p, got)
        require(np.all(np.abs(exact - wsc[:10]) <= 1e-4), "maxsim ids")
        require(np.max(np.abs(exact - [r.score for r in row])) <= 1e-3, "maxsim scores")
    log(f"maxsim: {nq} query sets exact")
    with phase("muvera_fde_candidates"):
        fres = col.multi_vector_search_batch([qs.tolist() for qs in qsets], limit=10,
                                             candidates=max(64, n // 100))
    for row, p in zip(fres, prepared):
        got = np.asarray([int(r.id[1:]) for r in row])
        exact = mv_reference(stored, p, got)
        require(np.max(np.abs(exact - [r.score for r in row])) <= 1e-3, "fde rerank scores")
        require(all(a >= b - 1e-6 for a, b in zip(exact, exact[1:])), "fde order")
    hit1 = np.mean([int(row[0].id[1:]) == s for row, s in zip(fres, src)])
    ov = overlap([[int(r.id[1:]) for r in row] for row in fres],
                 [w[0].tolist() for w in want])
    log(f"muvera-fde: source doc first for {hit1:.3f} of queries; overlap@10 vs "
        f"exact {ov:.4f}")
    require(hit1 >= 0.9, hit1)
    with phase("hybrid_maxsim_mmr"):
        qv = np.stack([p.mean(axis=0) for p in prepared])
        # powers of two: the "search" generator's count is bucketed to one
        gens = [("search", {"candidates": 128}), ("quantized", {"candidates": 128})]
        hyb = col.hybrid_search_batch(qv, limit=10, generators=gens,
                                      rerank=("multi_vector", [qs.tolist() for qs in qsets]))
        prim = col.index._host_x[:n]
        qp = col._prepare_query_batch(qv).astype(np.float32)
        s_ids, _ = exact_top(prim, qp, 128)
        signs = np.where(np.asarray(prim) >= 0, 1.0, -1.0).astype(np.float32)
        ham = (d - np.where(qp >= 0, 1.0, -1.0).astype(np.float32) @ signs.T) / 2
        q_ids = np.argsort(ham, axis=1, kind="stable")[:, :128]
        for row, p, a, b in zip(hyb, prepared, s_ids, q_ids):
            union = np.union1d(a, b)
            sc = mv_reference(stored, p, union)
            order = np.lexsort((union, -sc))[:10]
            got = np.asarray([int(r.id[1:]) for r in row])
            require(np.all(np.abs(mv_reference(stored, p, got) - sc[order]) <= 1e-4), "hybrid")
        log(f"hybrid: {nq} queries match the MaxSim rerank of the union")
        pools = [[(r.id, np.asarray(col.get(r.id).vector)) for r in row] for row in hyb]
        initial = [[(r.id, float(r.score)) for r in row] for row in hyb]
        host = [mmr_rerank(i, [(a, list(v)) for a, v in p], "cosine", 0.5, 5)
                for i, p in zip(initial, pools)]
        dev = mmr_rerank_batch(initial, np.stack([np.stack([v for _, v in p]) for p in pools]),
                               metric="cosine", alpha=0.5, final_k=5)
        require([[a for a, _ in h] for h in host] == [[a for a, _ in g] for g in dev], "mmr")
        log("mmr: device batch equals the host reranker")
    col.close()


def run_pytest():
    import pytest

    class Count:
        def __init__(self):
            self.outcomes = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome == "skipped":
                self.outcomes[report.outcome] = self.outcomes.get(report.outcome, 0) + 1

    count = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests", "test_flat_scan_kernel.py")],
                     plugins=[count])
    log(f"pytest -m gpu: rc {int(rc)} {count.outcomes}")
    require(int(rc) == 0 and count.outcomes.get("passed", 0) >= 3)
    require(not count.outcomes.get("skipped") and not count.outcomes.get("failed"))


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def mesh_phases(sz, rng, jax, jnp, vt):
    """The mesh path on every device, each mode against the one-card path."""
    from vettore_tpu.parallel import ShardedHnsw, make_mesh
    from vettore_tpu.parallel.ivf_mesh import ShardedIvf

    devices = jax.devices()
    mesh = make_mesh(devices)
    log(f"mesh {dict(mesh.shape)} over {len(devices)} devices")

    def spread_ok(arr, what):
        held = len(arr.sharding.device_set)
        require(held == len(devices), f"{what} on {held} of {len(devices)} devices")

    n, d = sz["n"], sz["d"]
    with phase("mesh_data"):
        data = clustered(n, d, rng)
        ids = [f"d{i:07d}" for i in range(n)]
        q = near(data, sz["batch"], rng)
    with phase(f"mesh_flat_{n}x{d}"):
        mcol = vt.Collection(name="mesh", dimensions=d, metric="cosine",
                             index="flat", mesh=mesh)
        mcol.put_matrix(ids, data)
        got = mcol.search_batch(q, limit=10)
        spread_ok(mcol.index._sharded._x, "flat block")
        prepared = mcol._prepare_query_batch(q).astype(np.float32)
        _, ref_sc = exact_top(data, prepared, 10)
        check_exact("mesh flat", hit_ids(got), [[r.score for r in row] for row in got],
                    data, prepared, ref_sc)
        per = [(dev.memory_stats() or {}).get("bytes_in_use") for dev in devices]
        log(f"bytes in use per device: {per}")
        if devices[0].platform == "gpu":
            require(min(per) > 0.2 * max(per), "device memory is not spread over the mesh")
    mcol.close()
    del mcol, data, ids
    gc.collect()
    # the other modes on their own corpus, at the 1M corpus's cluster density
    sn = sz["mesh_small_n"]
    sub = clustered(sn, d, rng)
    sub_ids = [f"s{i:07d}" for i in range(sn)]
    sq = near(sub, 64, rng)
    with phase(f"mesh_funnel_quantized_{sn}"):
        scol = vt.Collection(name="mesh-small", dimensions=d, metric="cosine",
                             index="flat", mesh=mesh)
        scol.put_matrix(sub_ids, sub)
        single = vt.Collection(name="single", dimensions=d, metric="cosine", index="flat")
        single.put_matrix(sub_ids, sub)
        for mode, kw in (("funnel_search_batch", {"stages": [128, 256, 384], "candidates": 200}),
                         ("quantized_search_batch", {"candidates": 500})):
            a = [[r.id for r in row] for row in getattr(scol, mode)(sq, limit=10, **kw)]
            b = [[r.id for r in row] for row in getattr(single, mode)(sq, limit=10, **kw)]
            require(a == b, mode)
            log(f"{mode}: mesh == one card")
        single.close()
    with phase(f"mesh_ivf_hnsw_{sn}"):
        from vettore_tpu.parallel import ShardedFlat

        flat = ShardedFlat("cosine", mesh, sub_ids, sub)
        want = flat.search_batch(sq, 10)
        ivf = ShardedIvf("cosine", mesh, sub_ids, sub,
                         options={"n_probe": 65_536, "storage": "f32"})
        got = ivf.search_batch(sq, 10)
        require([[i for i, _ in r] for r in got] == [[i for i, _ in r] for r in want], "ivf")
        log("sharded ivf (every block probed) == sharded exact scan")
        ann = ShardedHnsw("cosine", mesh, sub_ids, sub,
                          options={"m": 16, "m0": 32, "ef_construction": 100,
                                   "ef_search": 64, "build": "knn"})
        r = overlap([[i for i, _ in row] for row in ann.search_batch(sq, 10)],
                    [[i for i, _ in row] for row in want])
        log(f"sharded hnsw recall@10 {r:.4f}")
        require(r >= 0.95, r)
    with phase("mesh_maxsim_hybrid"):
        mn, t = sz["mesh_mv_n"], 32
        toks = rng.standard_normal((mn, t, 128), dtype=np.float32)
        mv_ids = [f"m{i:06d}" for i in range(mn)]
        cols = []
        for m in (mesh, None):
            c = vt.Collection(name="mv", dimensions=128, metric="cosine", mesh=m)
            c.put_tokens(mv_ids, toks)
            cols.append(c)
        qsets = [toks[i, :8].tolist() for i in range(8)]
        qv = [toks[i].mean(axis=0).tolist() for i in range(8)]
        a, b = (c.multi_vector_search_batch(qsets, limit=10) for c in cols)
        require([[r.id for r in row] for row in a] == [[r.id for r in row] for row in b], "maxsim")
        gens = [("funnel", {"candidates": 50}), ("quantized", {"candidates": 50})]
        a, b = (c.hybrid_search_batch(qv, limit=10, generators=gens,
                                      rerank=("multi_vector", qsets)) for c in cols)
        require([[r.id for r in row] for row in a] == [[r.id for r in row] for row in b], "hybrid")
        log("sharded maxsim and hybrid == one card")
        for c in cols:
            c.close()
    with phase("mesh_delete_snapshot"):
        gone = [row[0].id for row in scol.search_batch(sq[:4], limit=1)]
        for g in gone:
            scol.delete(g)
        after = scol.search_batch(sq[:4], limit=10)
        require(not ({r.id for row in after for r in row} & set(gone)))
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "mesh.vsnap")
            scol.snapshot(path)
            loaded = vt.load_snapshot(path, mesh=mesh)
            again = loaded.search_batch(sq[:4], limit=10)
            require([[r.id for r in row] for row in after]
                    == [[r.id for r in row] for row in again], "snapshot reload")
            loaded.close()
        scol.close()
        log("delete and snapshot reload on the mesh")


# ---------------------------------------------------------------------------


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, choices=(1, 4), default=1)
    p.add_argument("--only", default="", help="comma-separated phases to run")
    p.add_argument("--seed", type=int, default=20_260_721)
    p.add_argument("--rehearse", action="store_true",
                   help="tiny sizes on any platform; prints no result, exits 3")
    args = p.parse_args(argv)

    import jax

    device = jax.devices()[0]
    if device.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: needs a GPU; JAX's first device is {device.platform}",
              file=sys.stderr, flush=True)
        sys.exit(1)
    if len(jax.devices()) < args.devices:
        print(f"chip_smoke: --devices {args.devices} but JAX sees "
              f"{len(jax.devices())}", file=sys.stderr, flush=True)
        sys.exit(1)
    print(f"card: {card_line() if device.platform == 'gpu' else 'no GPU (rehearsal)'}",
          flush=True)

    import jax.numpy as jnp

    import vettore_tpu as vt

    sz = TINY if args.rehearse else FULL
    phases = MESH_PHASES if args.devices == 4 else SINGLE_PHASES
    only = [s for s in args.only.split(",") if s]
    unknown = set(only) - set(phases)
    if unknown:
        p.error(f"unknown phases for --devices {args.devices}: {sorted(unknown)}")
    wanted = [ph for ph in phases if not only or ph in only]
    rng = np.random.default_rng(args.seed)
    print(f"jax {jax.__version__} devices {jax.devices()} phases {wanted}", flush=True)
    t_all = time.perf_counter()
    ctx = Ctx()
    needs_main = {"flat", "kernel_timing", "funnel_quantized", "ivf", "hnsw"}
    if args.devices == 4:
        with phase("mesh"):
            mesh_phases(sz, rng, jax, jnp, vt)
    else:
        if needs_main & set(wanted):
            with phase("flat"):
                flat_main(ctx, sz, rng, jax, jnp, vt)
        if "kernel_timing" in wanted:
            with phase("kernel_timing"):
                kernel_timing(ctx, sz, jax, jnp, interpret=device.platform != "gpu")
        if "funnel_quantized" in wanted:
            funnel_quantized(ctx, sz, rng, jnp)
        if "hnsw" in wanted:
            hnsw(ctx, sz, rng, vt)
        if "ivf" in wanted:
            ctx.flat["f32"][0].close()
            ivf(ctx, sz, vt)
        ctx = None
        gc.collect()
        if "flat_small" in wanted:
            flat_small(sz, rng, vt)
        if "maxsim" in wanted:
            maxsim_modes(sz, rng, vt, jnp)
        if "pytest" in wanted and not args.rehearse:
            with phase("pytest_gpu_marker"):
                run_pytest()
    print(f"[phase] total: {time.perf_counter() - t_all:.2f} s", flush=True)
    if args.rehearse:
        print("rehearsal passed; no device result", flush=True)
        sys.exit(3)
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
