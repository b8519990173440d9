"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline (BASELINE.json): **QPS at recall@10 >= 0.95 on 1M x 768 cosine**,
HNSW (m=16, m0=32, ef_construction=100) with the flat exact scan as ground
truth, plus index build time. The detail dict carries every other BASELINE
config: flat exact f32/bf16, binary-quantized candidates=500 + exact rerank,
Matryoshka funnel [128, 256, 384] candidates=200, and hybrid -> ColBERT
MaxSim (32 x 128d token vectors) -> MMR, each with an overlap@10 preflight
against the exact oracle BEFORE timing (the reference bench discipline,
/root/reference/bench/search_modes_bench.exs:193-238).

Operational design:

* **Wall-clock budget** (`VETTORE_BENCH_BUDGET_S`, default 1050 s): every
  phase is guarded; when the remaining budget can't cover a phase it is
  skipped and recorded in ``detail["skipped"]``. SIGTERM/SIGALRM emit the
  best-so-far JSON line and exit — the run never ends without a result.
* **Disk caches** (`VETTORE_BENCH_CACHE`, default ``.bench_cache/`` in the
  checkout): the host canonical corpus copies (u16 halves) and the CPU
  baseline cache across runs, with the saved HNSW graph (adjacency only) as
  a fallback for budget-starved runs. ``python bench.py --prime-cache``
  builds all caches without timing.
* **Barriers**: every warmup and timed region ends with
  ``jax.block_until_ready`` on the last dispatched output.
* Timed dispatches rotate over PRE-STAGED query blocks (``staged_slices``:
  materialized before the timed region) so no functional caching or result
  reuse can inflate QPS; latency percentiles come from a separate
  serialized (barrier-per-dispatch) loop.

No number from this harness has been recorded on the H100 yet.

Run: python bench.py                   (headline scale by cache/budget)
     python bench.py --scale=100k|300k|1m
     python bench.py --smoke           (tiny, CI-style)
     python bench.py --headline-only   (skip secondary modes)
     python bench.py --prime-cache     (build corpus+graph caches, no timing)
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

SEED = 20_260_721
#: expand_w=4: cheaper traversal steps at the same ef, a little recall for
#: speed; the ef sweep still raises ef if the recall gate ever fails
HNSW_PARAMS = {"m": 16, "m0": 32, "ef_construction": 100, "max_level": 12,
               "expand_w": 4}
EF_SWEEP = (16, 24, 32, 48, 64, 96, 128, 256, 512)
RECALL_GATE = 0.95
CACHE_DIR = os.environ.get(
    "VETTORE_BENCH_CACHE",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache"))
BUDGET_S = float(os.environ.get("VETTORE_BENCH_BUDGET_S", "1050"))

_T0 = time.monotonic()


def left() -> float:
    return BUDGET_S - (time.monotonic() - _T0)


# ---------------------------------------------------------------------------
# result state + emergency emit
# ---------------------------------------------------------------------------

STATE = {
    "metric": "startup",
    "value": 0.0,
    "unit": "qps",
    "vs_baseline": 0.0,
    "detail": {"skipped": [], "budget_s": BUDGET_S},
}
_EMITTED = False


def emit(final=False):
    global _EMITTED
    if _EMITTED:
        return
    _EMITTED = True
    STATE["detail"]["elapsed_s"] = round(time.monotonic() - _T0, 1)
    # self-documenting truncation: a record that lost phases to
    # the budget/alarm says so at the top level, not only via skipped[]
    if STATE["detail"].get("skipped"):
        STATE["detail"]["partial"] = True
    print(json.dumps(STATE), flush=True)


def _on_signal(signum, frame):
    STATE["detail"]["skipped"].append(f"signal_{signum}")
    emit()
    os._exit(0)


def _phase(msg):
    print(f"[bench] {left():.0f}s left | {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# data generation + caches
# ---------------------------------------------------------------------------


def _cache_path(name):
    os.makedirs(CACHE_DIR, exist_ok=True)
    return os.path.join(CACHE_DIR, name)


def corpus_cache_name(n, d, seed=SEED, tag=""):
    return f"corpusdev{tag}_{n}x{d}_s{seed}.u16.npy"


def corpus_with_device(n, d, seed=SEED, tag=""):
    """Returns ``(host_f32, device_block)`` of the bench corpus: unit
    vectors in Gaussian clusters (sigma = radius/sqrt(d); cluster count
    ~n/100), bf16-rounded — real-embedding-like geometry.

    The corpus is generated ON DEVICE (vettore_tpu/synth.py, deterministic
    Threefry) in seconds; the host canonical copy is downloaded as u16
    halves ONCE and disk-cached. Warm runs load the cache and *adopt* the
    regenerated device block (sample-verified bit-identical) instead of
    uploading it from the host."""
    from vettore_tpu import synth
    from vettore_tpu.ops.transport import get_f32_matrix

    dev = synth.clustered(n, d, max(1024, n // 100), 0.4, seed)
    path = _cache_path(corpus_cache_name(n, d, seed, tag))
    if os.path.exists(path):
        halves = np.load(path)
        host = (halves.astype(np.uint32) << 16).view(np.float32)
        if host.shape != (n, d):  # stale/foreign cache: rebuild from device
            host = None
    else:
        host = None
    if host is None:
        host = get_f32_matrix(dev)  # downloaded as u16 halves
        np.save(path, (host.view(np.uint32) >> 16).astype(np.uint16))
    return host, dev


def cached_corpus(n, d, seed=SEED, tag=""):
    """Host corpus only."""
    return corpus_with_device(n, d, seed, tag)[0]


def adopt_or_upload(flat, dev, detail=None, key=None):
    """Adopts the regenerated device block into a flat index (bit-verified
    sample), falling back to the plain upload path on any mismatch."""
    try:
        flat.adopt_device_block(dev)
        mode = "adopted"
    except Exception as exc:  # noqa: BLE001 — fallback must be total
        _phase(f"block adoption failed ({exc}); uploading")
        flat._sync_device()
        mode = "uploaded"
    if detail is not None and key is not None:
        detail[key] = mode
    return mode


def make_queries(data, count, noise_norm=0.4, seed=SEED + 1):
    """Held-out queries: corpus points + noise at the cluster-radius norm."""
    from vettore_tpu.ops.transport import round_to_bf16

    rng = np.random.default_rng(seed)
    sigma = np.float32(noise_norm / np.sqrt(data.shape[1]))
    qs = data[rng.integers(0, data.shape[0], count)] + sigma * rng.standard_normal(
        (count, data.shape[1]), dtype=np.float32
    )
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    return round_to_bf16(qs)


def overlap_at_k(hits, truth, k=10):
    scores = []
    for h, t in zip(hits, truth):
        got = {id for id, _ in h[:k]}
        expect = {id for id, _ in t[:k]}
        scores.append(len(got & expect) / k)
    return float(np.mean(scores))


def cpu_single_core_qps_cached(data, queries, n, d, limit=10, count=4):
    """Disk-cached wrapper: the baseline is a property of (corpus, host), not
    of the build under test — pay the 3 GB tmp-file round-trip once."""
    path = _cache_path(f"cpu_baseline_dev_{n}x{d}_s{SEED}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)["qps"]
    qps = cpu_single_core_qps(data, queries, limit=limit, count=count)
    with open(path, "w") as f:
        json.dump({"qps": qps}, f)
    return qps


def cpu_single_core_qps(data, queries, limit=10, count=4):
    """Single-core CPU exact scan in a constrained subprocess (stand-in for
    the reference's single-core Rust NIF flat scan)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        np.save(f"{tmp}/data.npy", data)
        np.save(f"{tmp}/queries.npy", queries[:count])
        code = f"""
import numpy as np, time
data = np.load("{tmp}/data.npy")
queries = np.load("{tmp}/queries.npy")
scores = data @ queries[0]
np.argpartition(-scores, {limit})[:{limit}]
t0 = time.perf_counter()
for q in queries:
    scores = data @ q
    np.argpartition(-scores, {limit})[:{limit}]
print(len(queries) / (time.perf_counter() - t0))
"""
        env = dict(os.environ)
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
            env[var] = "1"
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True, env=env,
            timeout=1800,
        )
        return float(out.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


def timed_qps(dispatch, iters, per_iter_queries):
    """``dispatch(i)`` enqueues batch ``i`` (rotating inputs so no functional
    reuse can skip work) and returns device output. Pipelined loop: one
    barrier at the end."""
    import jax

    jax.block_until_ready(dispatch(0))  # warm: compile + execute
    t0 = time.perf_counter()
    last = None
    for i in range(iters):
        last = dispatch(i)
    jax.block_until_ready(last)
    return per_iter_queries * iters / (time.perf_counter() - t0)


def staged_slices(qdev, batch, count=8, stride=37):
    """Pre-staged rotating query blocks for the timed loops. Slicing with an
    eager ``dynamic_slice`` inside the timed region would add a host-side
    dispatch per iteration; staging the blocks first leaves only the search
    dispatch in the loop; inputs still rotate
    (distinct blocks per iteration) so no result reuse can skip work."""
    import jax

    top = max(1, qdev.shape[0] - batch + 1)
    blocks = [jax.lax.dynamic_slice_in_dim(qdev, (i * stride) % top, batch)
              for i in range(count)]
    jax.block_until_ready(blocks[-1])
    return blocks


def timed_percentiles(dispatch, iters=10):
    """Serialized per-dispatch latency (barrier each iteration):
    returns {p50_ms, p99_ms} over ``iters`` dispatches."""
    import jax

    jax.block_until_ready(dispatch(0))
    lat = []
    for i in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(dispatch(i))
        lat.append((time.perf_counter() - t0) * 1000)
    lat = np.array(lat)
    return {"p50_ms": round(float(np.percentile(lat, 50)), 2),
            "p99_ms": round(float(np.percentile(lat, 99)), 2)}


def timed_sync_percentiles(call, iters=6):
    """Per-call wall-clock percentiles for synchronous (host-returning)
    pipelines — collection batch APIs device_get before returning, so each
    call is its own barrier."""
    call(0)
    lat = []
    for i in range(iters):
        t0 = time.perf_counter()
        call(i)
        lat.append((time.perf_counter() - t0) * 1000)
    lat = np.array(lat)
    return {"p50_ms": round(float(np.percentile(lat, 50)), 2),
            "p99_ms": round(float(np.percentile(lat, 99)), 2)}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def pick_scale(args):
    for a in args:
        if a.startswith("--scale="):
            return {"100k": (100_000, 768), "300k": (300_000, 768),
                    "1m": (1_000_000, 768), "1M": (1_000_000, 768)}[a.split("=", 1)[1]]
    if "--smoke" in args:
        return (2_000, 64)
    # budget-aware ladder, consulted at start-up so left() reflects the real
    # remaining budget. Corpora are device-generated and the flat block is
    # adopted (no upload); what "cold" still pays is the one-time u16
    # download of the host canonical copy — hence the lower bar when the
    # corpus disk cache is present. A wiped HNSW graph
    # cache must NOT demote the scale (that phase self-skips/bulk-builds).
    for n, need_cold, need_cached in ((1_000_000, 600.0, 420.0),
                                      (300_000, 300.0, 220.0)):
        cached = os.path.exists(_cache_path(corpus_cache_name(n, 768)))
        if left() > (need_cached if cached else need_cold):
            return (n, 768)
    return (100_000, 768)


def graph_cache_name(n, d):
    # v4: kNN-block build at PROBES=24 (richer candidate pools than v3's
    # 16-probe graphs; v2 were wave-built, v1 host-RNG-era corpora).
    p = HNSW_PARAMS
    return f"hnsw_{n}x{d}_m{p['m']}m0{p['m0']}efc{p['ef_construction']}_s{SEED}_v4.npz"


def hnsw_build_estimate(n):
    """Budget estimate for a cold kNN-block build, compiles included (a
    guess kept from another accelerator; not measured on the H100)."""
    return max(30.0 if n <= 50_000 else 90.0, n / 1_000_000 * 260)


def _record_cold_build(graph_path, seconds):
    """Persists the measured cold-build seconds next to the graph cache so
    cache-hit runs can still report an honest ``hnsw_build_cold_s``
    (the cost must stay visible even when primed)."""
    try:
        with open(graph_path + ".build.json", "w") as f:
            json.dump({"hnsw_build_cold_s": round(seconds, 1)}, f)
    except Exception:
        pass


def _load_cold_build(graph_path):
    try:
        with open(graph_path + ".build.json") as f:
            return json.load(f)["hnsw_build_cold_s"]
    except Exception:
        return None


def prime_main(n, d):
    """Cache-priming with minimal device residency: the timed path holds the
    flat index block (3 GB at 1M x 768) *plus* the build's permuted copy.
    Priming needs neither timing nor ground truth, so build the graph from
    one uploaded corpus block (peak = 2 copies + wave working set) and
    persist only the adjacency."""
    import jax.numpy as jnp

    from vettore_tpu.index.hnsw import HnswIndex
    import jax

    _phase(f"prime: corpus {n}x{d}")
    data, dev = corpus_with_device(n, d)
    ids = [f"doc-{i:07d}" for i in range(n)]

    graph_path = _cache_path(graph_cache_name(n, d))
    if not os.path.exists(graph_path):
        _phase(f"prime: hnsw build (est {hnsw_build_estimate(n):.0f}s)")
        t0 = time.perf_counter()
        hnsw = HnswIndex("cosine", {**HNSW_PARAMS, "ef_search": EF_SWEEP[0]})
        hnsw.bulk_ingest_device(ids, dev)
        del dev
        jax.block_until_ready(hnsw._bulk.a0)
        build_s = time.perf_counter() - t0
        _phase(f"prime: built in {build_s:.1f}s; saving graph")
        hnsw.save_graph(graph_path, include_x=False)
        _record_cold_build(graph_path, build_s)
        del hnsw
    else:
        _phase("prime: graph cache already present")
        del dev  # frees the 3 GB block before the MV phase

    # multi-vector corpus + graph caches (config 5; small next to the 1M
    # block). Run the hybrid phase itself: it builds AND saves the MV HNSW
    # graph when the cache is missing (a cold build inside the timed run
    # eats the hybrid phase's whole budget), and its primaries byte-match
    # put_tokens' normalize-mean-normalize pipeline by construction.
    _phase("prime: hybrid/mv phase (builds mv graph cache)")
    try:
        run_hybrid_mv({}, n, prime=True)
    except Exception as exc:  # cache priming is best-effort
        _phase(f"prime: hybrid/mv failed: {exc}")

    # CPU single-core baseline (the vs_baseline denominator): ~8 min uncached
    # at 1M x 768 (3 GB tmp round-trip + single-core scans) — pay it here so
    # the timed run never spends budget on it
    _phase("prime: cpu single-core baseline")
    cpu_single_core_qps_cached(data, make_queries(data, 8), n, d)
    STATE.update({"metric": "prime_cache", "value": 1.0, "unit": "ok"})
    emit(final=True)


def main():
    args = sys.argv[1:]
    headline_only = "--headline-only" in args
    prime = "--prime-cache" in args
    smoke = "--smoke" in args

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGALRM, _on_signal)
    if not prime:
        signal.alarm(max(30, int(left()) - 15))

    if prime:
        if not any(a.startswith("--scale=") for a in args) and not smoke:
            n, d = 1_000_000, 768
        else:
            n, d = pick_scale(args)
        prime_main(n, d)
        return
    batch = 32 if smoke else 512
    q_count = 32 if smoke else 512
    detail = STATE["detail"]

    import jax
    import jax.numpy as jnp

    from vettore_tpu.index.flat import FlatIndex
    from vettore_tpu.index.hnsw import HnswIndex

    dev0 = jax.devices()[0]
    detail["device"] = {"platform": dev0.platform, "kind": dev0.device_kind,
                        "count": len(jax.devices())}
    n, d = pick_scale(args)
    detail.update({"batch": batch, "scale": f"{n}x{d}",
                   "corpus": f"clustered({max(1024, n // 100)}centers,radius0.4)",
                   "query_noise_norm": 0.4})

    # ---- corpus (device-generated; host canonical copy disk-cached)
    _phase(f"corpus {n}x{d}")
    t0 = time.perf_counter()
    data, data_dev = corpus_with_device(n, d)
    ids = [f"doc-{i:07d}" for i in range(n)]
    # 2x the batch so timed dispatches rotate over genuinely different slices
    queries = make_queries(data, 2 * max(q_count, batch))
    detail["corpus_s"] = round(time.perf_counter() - t0, 1)

    # ---- flat exact (ground truth + config-1-style throughput). ONE
    # Collection owns the corpus: its FlatIndex is the flat index under test
    # AND the adaptive modes' scan cache shares its device block — the 3 GB
    # block lives on device exactly once, ADOPTED from the generator
    # (sample-verified vs the host store) rather than uploaded.
    # normalize="none": the synth corpus is already unit-norm (pre-rounding)
    # and cosine is norm-invariant, so skipping insert-time renormalization
    # keeps the stored rows bit-identical to the device block — the adopt
    # precondition — and skips an O(n) f64 host pass.
    _phase("flat ingest")
    from vettore_tpu.collection import Collection

    col = Collection(name="bench", dimensions=d, metric="cosine", index="flat",
                     normalize="none")
    detail["normalize"] = "none"
    t0 = time.perf_counter()
    col.put_matrix(ids, data)
    flat = col.index
    detail["flat_build_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    adopt_or_upload(flat, data_dev, detail, "flat_block")
    jax.block_until_ready(flat._device[0])
    del data_dev
    detail["flat_upload_s"] = round(time.perf_counter() - t0, 1)
    _phase(f"flat host {detail['flat_build_s']}s device "
           f"{detail['flat_upload_s']}s ({detail['flat_block']})")

    _phase("ground truth")
    truth = flat.search_batch(queries[:q_count], 10)
    qdev = jnp.asarray(queries.astype(np.float32))

    qslices = staged_slices(qdev, batch)

    def flat_dispatch(i, index=flat):
        return index.search_batch_device(qslices[i % len(qslices)], 10)

    detail["flat_exact_qps"] = round(timed_qps(flat_dispatch, 24, batch), 1)
    detail["flat_exact"] = timed_percentiles(flat_dispatch)
    # sync_*: the whole Python API per batch incl. query upload + hydration
    # (throughput vs latency semantics must be explicit)
    detail["flat_exact"].update({f"sync_{k}": v for k, v in timed_sync_percentiles(
        lambda i, b=batch: flat.search_batch(
            queries[(i * 29) % max(1, len(queries) - b + 1):][:b], 10)).items()})
    _phase(f"flat f32 {detail['flat_exact_qps']} qps {detail['flat_exact']}")

    # headline fallback BEFORE any further phase: whatever stalls later, the
    # record carries a real number
    STATE.update({
        "metric": f"flat_exact_qps_{n}x{d}_cosine", "value": detail["flat_exact_qps"],
    })

    if left() > 120:
        try:
            flat16 = flat.storage_view("bf16")
            hits16 = flat16.search_batch(queries[:q_count], 10)
            detail["flat_bf16"] = {
                "qps": round(timed_qps(lambda i: flat_dispatch(i, flat16), 24, batch), 1),
                "overlap_at_10": round(overlap_at_k(hits16, truth), 4),
                **timed_percentiles(lambda i: flat_dispatch(i, flat16)),
            }
            _phase(f"flat bf16 {detail['flat_bf16']}")
            del flat16  # frees the 1.5 GB bf16 block before the HNSW build
            _promote_headline(detail, n, d)
        except Exception as exc:
            detail["skipped"].append(f"flat_bf16_error:{type(exc).__name__}")
            _phase(f"flat bf16 failed: {exc}")
    else:
        detail["skipped"].append("flat_bf16_budget")

    # ---- IVF (vettore_tpu/index/ivf.py): k-means routing +
    # contiguous-block rescore. The build is dense k-means, so
    # it always runs cold — no cache, and ivf_build_s is an honest cold
    # number every run.
    if left() > 90:
        try:
            from vettore_tpu.index.ivf import IvfIndex

            _phase("ivf build (cold)")
            t0 = time.perf_counter()
            ivf = IvfIndex.from_flat(flat, {"n_probe": 4, "storage": "bf16"})
            ivf.rebuild()
            jax.block_until_ready(ivf._bcb)
            detail["ivf_build_s"] = round(time.perf_counter() - t0, 1)
            _phase(f"ivf built in {detail['ivf_build_s']}s; n_probe sweep")
            for p in (4, 8, 16, 32, 64):
                if p * 64 > n:
                    break
                ivf.params["n_probe"] = p
                hits = ivf.search_batch(queries[:q_count], 10)
                r = overlap_at_k(hits, truth)
                _phase(f"  n_probe={p}: recall@10={r:.4f}")
                if r >= RECALL_GATE or p == 64 or left() < 90:
                    def ivf_dispatch(i):
                        return ivf.search_batch_device(
                            qslices[i % len(qslices)], 10)

                    qps = timed_qps(ivf_dispatch, 24, batch)
                    sync_i = timed_sync_percentiles(
                        lambda i, b=batch: ivf.search_batch(
                            queries[(i * 29) % max(1, len(queries) - b + 1):][:b],
                            10))
                    detail["ivf"] = {
                        "qps": round(qps, 1), "n_probe": p,
                        "recall_at_10": round(r, 4),
                        # p50/p99: pipelined device serving path; sync_*:
                        # whole Python API per batch
                        **timed_percentiles(ivf_dispatch),
                        "sync_p50_ms": sync_i["p50_ms"],
                        "sync_p99_ms": sync_i["p99_ms"],
                    }
                    if r >= RECALL_GATE or left() < 90:
                        break
            _phase(f"ivf {detail.get('ivf')}")
            _promote_headline(detail, n, d)
            del ivf
        except Exception as exc:
            detail["skipped"].append(f"ivf_error:{type(exc).__name__}")
            _phase(f"ivf failed: {exc}")
    else:
        detail["skipped"].append("ivf_budget")

    # ---- HNSW (config 2): the kNN-block build is cheap enough to run COLD
    # every run (like the IVF build, the honest-cold-number posture); the
    # graph cache only rescues budget-starved runs.
    graph_path = _cache_path(graph_cache_name(n, d))
    hnsw = None
    est_build = hnsw_build_estimate(n)
    # margin: the phases that must still fit after the build are themselves
    # scale-dependent (toy-scale modes run in seconds)
    build_margin = 60 if n <= 50_000 else 180
    if prime or left() > est_build + build_margin:
        _phase(f"hnsw cold build (est {est_build:.0f}s)")
        t0 = time.perf_counter()
        hnsw = HnswIndex("cosine", {**HNSW_PARAMS, "ef_search": EF_SWEEP[0]})
        hnsw.bulk_ingest_device(ids, flat._device[0][: len(ids)])
        jax.block_until_ready(hnsw._bulk.a0)
        detail["hnsw_build_s"] = round(time.perf_counter() - t0, 1)
        detail["hnsw_build_cold_s"] = detail["hnsw_build_s"]
        _phase(f"built in {detail['hnsw_build_s']}s")
        if not os.path.exists(graph_path):
            try:
                hnsw.save_graph(graph_path, include_x=False)
                _record_cold_build(graph_path, detail["hnsw_build_s"])
            except Exception as exc:  # cache is best-effort
                _phase(f"graph cache save failed: {exc}")
    elif os.path.exists(graph_path):
        _phase("hnsw graph cache hit (budget too tight for a cold build)")
        t0 = time.perf_counter()
        with np.load(graph_path, allow_pickle=False) as z:
            graph_ids = [str(i) for i in z["ids"]]
        perm = np.fromiter((flat._slot_of[i] for i in graph_ids), dtype=np.int32,
                           count=len(graph_ids))
        x_dev = flat._device[0][jnp.asarray(perm)]
        hnsw = HnswIndex.load_graph(
            "cosine", {**HNSW_PARAMS, "ef_search": EF_SWEEP[0]}, graph_path,
            x_device=x_dev)
        jax.block_until_ready(hnsw._bulk.a0)
        detail["hnsw_build_s"] = 0.0
        cold = _load_cold_build(graph_path)
        if cold is not None:
            detail["hnsw_build_cold_s"] = cold
        detail["hnsw_graph_load_s"] = round(time.perf_counter() - t0, 1)
        _phase(f"graph loaded in {detail['hnsw_graph_load_s']}s "
               f"(cold build was {cold}s)")
    else:
        detail["skipped"].append("hnsw_build_budget")

    baseline_qps = None
    if hnsw is not None:
        _phase("ef sweep")
        hnsw_qps, hnsw_recall, used_ef = None, 0.0, None
        for ef in EF_SWEEP:
            if ef > n:
                break
            hnsw.params["ef_search"] = ef
            hits = hnsw.search_batch(queries[:q_count], 10)
            r = overlap_at_k(hits, truth)
            _phase(f"  ef={ef}: recall@10={r:.4f}")
            if r >= RECALL_GATE or ef == EF_SWEEP[-1] or left() < 120:
                def hnsw_dispatch(i):
                    return hnsw.search_batch_device(
                        qslices[i % len(qslices)], 10)

                qps = timed_qps(hnsw_dispatch, 12, batch)
                detail["hnsw"] = timed_percentiles(hnsw_dispatch, 8)
                hnsw_qps, hnsw_recall, used_ef = qps, r, ef
                if r >= RECALL_GATE or left() < 120:
                    break
        detail["recall_at_10"] = round(hnsw_recall, 4)
        detail["ef_search"] = used_ef
        detail["recall_gate"] = "pass" if hnsw_recall >= RECALL_GATE else "ef_sweep_exhausted"
        _phase(f"hnsw {hnsw_qps:.0f} qps at ef={used_ef} (recall {hnsw_recall:.4f})")
        detail["hnsw_qps"] = round(hnsw_qps, 1)
        STATE.update({
            "metric": f"hnsw_qps_at_recall10>={RECALL_GATE}_{n}x{d}_cosine",
            "value": round(hnsw_qps, 1),
        })
        _promote_headline(detail, n, d)

    # ---- CPU single-core baseline (the vs_baseline denominator) — cached
    # (prime builds it), and BEFORE the adaptive modes so vs_baseline
    # survives an alarm there. Uncached it costs ~8 min at 1M, so a cold run
    # only computes it when the remaining budget still covers the adaptive
    # modes afterwards.
    _phase("cpu baseline")
    try:
        if os.path.exists(
            _cache_path(f"cpu_baseline_dev_{n}x{d}_s{SEED}.json")
        ) or left() > (60 if n <= 50_000 else 900):  # toy baselines: seconds
            baseline_qps = cpu_single_core_qps_cached(data, queries, n, d)
            detail["cpu_single_core_exact_qps"] = round(baseline_qps, 2)
            STATE["vs_baseline"] = round(STATE["value"] / baseline_qps, 2)
        else:
            detail["skipped"].append("cpu_baseline_budget")
    except Exception as exc:
        detail["skipped"].append(f"cpu_baseline_error:{type(exc).__name__}")

    # ---- adaptive modes (quantized config 3, funnel config 4): the scan
    # cache shares the collection index's device block (no second upload)
    if not headline_only and (prime or left() > 120):
        try:
            cache = col._scan_cache()
            _x, _v = cache.vectors()
            jax.block_until_ready(_x)
            cand = min(500, n)

            qhits = col.quantized_search_batch(queries[:q_count], limit=10,
                                               candidates=cand)
            q_overlap = overlap_at_k(
                [[(r.id, r.score) for r in row] for row in qhits], truth)

            def quant_dispatch(i, b=batch):
                s = (i * 29) % max(1, len(queries) - b + 1)
                return col.quantized_search_batch(queries[s:s + b], limit=10,
                                                  candidates=cand)

            # QPS through the device-to-device serving path (pipelined, like
            # the flat/hnsw numbers); sync-API latency reported separately
            def quant_dispatch_dev(i):
                return col.quantized_search_batch_device(
                    qslices[i % len(qslices)], limit=10, candidates=cand)

            q_qps = timed_qps(quant_dispatch_dev, 12, batch)
            sync_q = timed_sync_percentiles(quant_dispatch)
            detail["quantized"] = {"qps": round(q_qps, 1), "candidates": cand,
                                   "overlap_at_10": round(q_overlap, 4),
                                   # p50/p99: device serving path (the basis
                                   # flat/hnsw report); sync_*: whole Python
                                   # API incl. query upload + hydration
                                   **timed_percentiles(quant_dispatch_dev),
                                   "sync_p50_ms": sync_q["p50_ms"],
                                   "sync_p99_ms": sync_q["p99_ms"]}
            _phase(f"quantized {detail['quantized']}")

            stages = tuple(s for s in (128, 256, 384) if s <= d) or (d,)
            fcand = min(200, n)
            fhits = col.funnel_search_batch(queries[:q_count], limit=10,
                                            candidates=fcand, stages=list(stages))
            f_overlap = overlap_at_k(
                [[(r.id, r.score) for r in row] for row in fhits], truth)

            def fun_dispatch(i, b=batch):
                s = (i * 29) % max(1, len(queries) - b + 1)
                return col.funnel_search_batch(queries[s:s + b], limit=10,
                                               candidates=fcand, stages=list(stages))

            def fun_dispatch_dev(i):
                return col.funnel_search_batch_device(
                    qslices[i % len(qslices)], limit=10,
                    candidates=fcand, stages=list(stages))

            f_qps = timed_qps(fun_dispatch_dev, 12, batch)
            sync_f = timed_sync_percentiles(fun_dispatch)
            detail["funnel"] = {"qps": round(f_qps, 1), "stages": list(stages),
                                "candidates": fcand,
                                "overlap_at_10": round(f_overlap, 4),
                                **timed_percentiles(fun_dispatch_dev),
                                "sync_p50_ms": sync_f["p50_ms"],
                                "sync_p99_ms": sync_f["p99_ms"]}
            _phase(f"funnel {detail['funnel']}")
            col.close()
            del col, cache
            _promote_headline(detail, n, d)
        except Exception as exc:
            detail["skipped"].append(f"adaptive_modes_error:{type(exc).__name__}")
            _phase(f"adaptive modes failed: {exc}")

    # ---- BASELINE config 1: flat exact cosine 100k x 384 f32, limit 10
    # (cheap — runs BEFORE the hybrid phase so a budget-starved run keeps
    # it; the hybrid gate below takes whatever budget remains)
    if not headline_only and not smoke and (n, d) != (100_000, 384) and (
            prime or left() > 60):
        try:
            _phase("flat 100k x 384 (config 1)")
            d1 = 384
            data1 = cached_corpus(100_000, d1, tag="c1")
            q1 = make_queries(data1, 2 * batch, seed=SEED + 21)
            f1 = FlatIndex("cosine")
            f1.put_matrix([f"c1-{i:06d}" for i in range(100_000)], data1)
            q1dev = jnp.asarray(q1.astype(np.float32))

            q1slices = staged_slices(q1dev, batch)

            def c1_dispatch(i):
                return f1.search_batch_device(q1slices[i % len(q1slices)], 10)

            detail["flat_100k_384"] = {
                "qps": round(timed_qps(c1_dispatch, 24, batch), 1),
                **timed_percentiles(c1_dispatch),
            }
            _phase(f"flat 100k {detail['flat_100k_384']}")
            del f1, q1dev, q1slices
        except Exception as exc:
            detail["skipped"].append(f"config1_error:{type(exc).__name__}")

    # ---- small/mid-scale latency matrix (bench/performance.md:27-31
    # prescribes 384d & 768d x {1k, 10k, 100k}): dispatch RTT dominates at
    # these sizes, which nothing else in the record guards
    if not headline_only and not smoke and (prime or left() > 90):
        for sn, sd in ((1_000, 384), (10_000, 384), (1_000, 768), (10_000, 768)):
            try:
                key = f"flat_{sn // 1000}k_{sd}"
                if key in detail or (sn, sd) == (n, d):
                    continue
                sdata = cached_corpus(sn, sd, tag=f"s{sn}")
                sq = make_queries(sdata, 2 * batch, seed=SEED + 31)
                sf = FlatIndex("cosine")
                sf.put_matrix([f"s-{i:06d}" for i in range(sn)], sdata)
                sslices = staged_slices(jnp.asarray(sq.astype(np.float32)), batch)

                def s_dispatch(i, f=sf, sl=sslices):
                    return f.search_batch_device(sl[i % len(sl)], 10)

                detail[key] = {
                    "qps": round(timed_qps(s_dispatch, 24, batch), 1),
                    **timed_percentiles(s_dispatch),
                }
                _phase(f"{key} {detail[key]}")
                del sf, sslices
                if left() < 60 and not prime:
                    break
            except Exception as exc:
                detail["skipped"].append(
                    f"small_scale_{sn}x{sd}_error:{type(exc).__name__}")

    # ---- hybrid -> MaxSim -> MMR (config 5) on the multi-vector corpus.
    # Warm phase cost with the adopted token block: MV corpus regen + token
    # cache load + put_tokens host pipeline + graph load + timed runs;
    # results emit progressively
    # inside run_hybrid_mv, so an alarm mid-phase degrades rather than
    # truncates the record.
    if not headline_only and not smoke and (prime or left() > 240):
        try:
            run_hybrid_mv(detail, n, prime)
        except Exception as exc:
            detail["skipped"].append(f"hybrid_mv_error:{type(exc).__name__}")
            _phase(f"hybrid/mv failed: {exc}")
    elif not headline_only and not smoke:
        detail["skipped"].append("hybrid_mv_budget")

    _promote_headline(detail, n, d)

    # vs_baseline was computed before the adaptive modes; refresh the ratio
    # in case the headline metric changed since
    if detail.get("cpu_single_core_exact_qps"):
        STATE["vs_baseline"] = round(
            STATE["value"] / detail["cpu_single_core_exact_qps"], 2)

    emit(final=True)


def _promote_headline(detail, n, d):
    """Headline: the BASELINE north star is recall@10 parity (>= 0.95 vs
    the exact scan) at maximum QPS — report the fastest qualifying mode,
    whichever it is.
    Called after EVERY measured mode so an alarm mid-run still emits the
    best number recorded so far, and again at the end."""
    contenders = [("flat_exact_f32", detail.get("flat_exact_qps"), 1.0)]
    if "flat_bf16" in detail:
        contenders.append(("flat_bf16", detail["flat_bf16"]["qps"],
                           detail["flat_bf16"]["overlap_at_10"]))
    if detail.get("recall_at_10") is not None and detail.get("hnsw_qps"):
        contenders.append(("hnsw", detail["hnsw_qps"], detail["recall_at_10"]))
    if "ivf" in detail:
        contenders.append(("ivf", detail["ivf"]["qps"],
                           detail["ivf"]["recall_at_10"]))
    for mode in ("quantized", "funnel"):
        if mode in detail:
            contenders.append((mode, detail[mode]["qps"],
                               detail[mode]["overlap_at_10"]))
    best = max(
        (c for c in contenders if c[1] and c[2] is not None and c[2] >= RECALL_GATE),
        key=lambda c: c[1], default=None)
    if best is not None and best[1] > STATE["value"]:
        detail["headline_mode"] = best[0]
        STATE.update({
            "metric": f"best_qps_at_recall10>={RECALL_GATE}_{n}x{d}_cosine",
            "value": round(best[1], 1),
        })
        if detail.get("cpu_single_core_exact_qps"):
            STATE["vs_baseline"] = round(
                STATE["value"] / detail["cpu_single_core_exact_qps"], 2)


def mv_caches(n):
    """Multi-vector corpus (config 5): docs AND the [cap, T, d] token block
    are generated ON DEVICE (synth.token_block over the doc block); the host
    canonical copies are downloaded once as u16 halves and disk-cached.
    Returns (mv_n, mv_d, mv_t, mv_docs, tokens, tok_dev) — ``tok_dev`` is the
    cap-padded device block ready for ``Collection.adopt_token_block`` (no
    1.6 GB token upload)."""
    from vettore_tpu import synth
    from vettore_tpu.collection import _cap_at_least
    from vettore_tpu.ops.transport import get_f32_matrix

    mv_n, mv_d, mv_t = min(n, 100_000), 128, 32
    _phase(f"multi-vector corpus {mv_n}x{mv_t}x{mv_d}")
    mv_docs, docs_dev = corpus_with_device(mv_n, mv_d, seed=SEED + 9, tag="mv")
    tok_dev = synth.token_block(docs_dev, mv_t, _cap_at_least(mv_n), mv_t,
                                0.3, SEED + 10)
    tok_path = _cache_path(f"mvtokdev_{mv_n}x{mv_t}x{mv_d}_s{SEED}.u16.npy")
    tokens = None
    if os.path.exists(tok_path):
        halves = np.load(tok_path)
        tokens = (halves.astype(np.uint32) << 16).view(np.float32)
        if tokens.shape != (mv_n, mv_t, mv_d):  # stale/foreign cache
            tokens = None
    if tokens is None:
        tokens = get_f32_matrix(tok_dev[:mv_n])
        np.save(tok_path, (tokens.view(np.uint32) >> 16).astype(np.uint16))
    return mv_n, mv_d, mv_t, mv_docs, tokens, tok_dev


def run_hybrid_mv(detail, n, prime):
    """Hybrid (hnsw+quantized generators) -> ColBERT MaxSim rerank -> MMR,
    config 5: 32 x 128d token vectors/doc. Round-3 serving path: the whole
    query batch runs through ``hybrid_search_batch`` (device generator union
    + batched MaxSim subset rerank) and a device MMR
    (ops/mmr.mmr_rerank_batch); the token block is bf16-resident, ADOPTED
    from the on-device generator rather than uploaded. Results land in
    ``detail['hybrid_maxsim_mmr']`` progressively (exact MaxSim first, then
    MUVERA-FDE, then the hybrid pipeline) so a budget alarm degrades the
    record instead of truncating it."""
    from vettore_tpu.collection import Collection
    from vettore_tpu.index.hnsw import HnswIndex
    from vettore_tpu.ops.mmr import mmr_rerank_batch
    from vettore_tpu.ops.transport import round_to_bf16

    mv_n, mv_d, mv_t, mv_docs, tokens, tok_dev = mv_caches(n)
    token_noise = np.float32(0.3 / np.sqrt(mv_d))

    mv_ids = [f"mv-{i:06d}" for i in range(mv_n)]
    # ingest against a FLAT index (bulk put_matrix path) — the HNSW graph is
    # attached below from cache/bulk; ingesting straight into an hnsw
    # collection would incrementally host-insert 100k nodes (~10 min) only
    # to throw the graph away. normalize="none": cosine is norm-invariant
    # and the stored tokens stay bit-identical to the generator block — the
    # adopt_token_block precondition.
    mv_col = Collection(name="bench-mv", dimensions=mv_d, metric="cosine",
                        index="flat", normalize="none")
    _phase("mv ingest")
    t0 = time.perf_counter()
    mv_col.put_tokens(mv_ids, tokens)  # bulk token ingest, no per-record walk
    try:
        mv_col.adopt_token_block(tok_dev)
        tok_mode = "adopted"
    except Exception as exc:  # noqa: BLE001 — fallback must be total
        _phase(f"token block adoption failed ({exc}); upload path")
        tok_mode = "uploaded"
    detail_build = time.perf_counter() - t0
    hm = detail.setdefault("hybrid_maxsim_mmr", {})
    hm.update({"docs": mv_n, "tokens": mv_t, "dims": mv_d,
               "token_block": tok_mode})

    mv_graph = _cache_path(f"mvgraphdev_{mv_n}x{mv_d}_s{SEED}_v2.npz")  # v2: knn build
    t0 = time.perf_counter()
    if os.path.exists(mv_graph):
        idx = HnswIndex.load_graph("cosine", {**HNSW_PARAMS, "ef_search": 64}, mv_graph)
        mv_col.attach_index(idx)
    else:
        idx = HnswIndex("cosine", {**HNSW_PARAMS, "ef_search": 64})
        primary = np.stack([np.asarray(mv_col.get(i).vector, np.float32) for i in mv_ids])
        idx.BULK_THRESHOLD = 2
        idx.put_many(zip(mv_ids, primary))
        idx.save_graph(mv_graph)
        mv_col.attach_index(idx)
    detail_build += time.perf_counter() - t0
    hm["build_s"] = round(detail_build, 1)

    qb = 64
    mv_queries = make_queries(mv_docs, 2 * qb, seed=SEED + 11)
    rq = np.random.default_rng(SEED + 12)
    qsets = [
        [list(t) for t in round_to_bf16(
            qv[None, :] + token_noise * rq.standard_normal((4, mv_d), dtype=np.float32))]
        for qv in mv_queries
    ]
    queries_l = [list(q) for q in mv_queries]
    cand = int(os.environ.get("VETTORE_BENCH_HYBRID_CAND", "1000"))
    gens = [("hnsw", {"candidates": cand}), ("quantized", {"candidates": cand})]

    def hybrid_batch(lo, hi):
        results = mv_col.hybrid_search_batch(
            queries_l[lo:hi], limit=30, generators=gens,
            rerank=("multi_vector", qsets[lo:hi]))
        initial = [[(r.id, float(r.score)) for r in row] for row in results]
        vecs = np.zeros((len(results), 30, mv_d), np.float32)
        for b, row in enumerate(results):
            for i, r in enumerate(row):
                vecs[b, i] = np.asarray(mv_col.get(r.id).vector, np.float32)
        reranked = mmr_rerank_batch(initial, vecs, metric="cosine",
                                    alpha=0.5, final_k=10)
        return results, reranked

    # exact full-corpus MaxSim FIRST (the chunked scan) — first call
    # compiles, second half times it
    _phase("exact maxsim (chunked scan)")
    exact = mv_col.multi_vector_search_batch(qsets[:qb], limit=10)
    t0 = time.perf_counter()
    mv_col.multi_vector_search_batch(qsets[qb : 2 * qb], limit=10)
    mv_qps = qb / (time.perf_counter() - t0)
    hm["exact_maxsim_qps"] = round(mv_qps, 1)
    hm["batch"] = qb
    _phase(f"exact maxsim {hm['exact_maxsim_qps']} qps")

    # MUVERA-FDE accelerated MaxSim (candidates + exact subset rerank):
    # first call pays the device doc-FDE encode, then steady-state QPS
    try:
        t0 = time.perf_counter()
        fde_hits = mv_col.multi_vector_search_batch(qsets[:qb], limit=10,
                                                    candidates=512)
        fde_first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mv_col.multi_vector_search_batch(qsets[qb : 2 * qb], limit=10,
                                         candidates=512)
        fde_qps = qb / (time.perf_counter() - t0)
        fde_overlap = float(np.mean([
            len({r.id for r in row} & {r.id for r in ex}) / 10
            for row, ex in zip(fde_hits, exact)
        ]))
        hm["muvera_fde"] = {"candidates": 512, "qps": round(fde_qps, 1),
                            "first_call_s": round(fde_first_s, 1),
                            "overlap_at_10_vs_exact_maxsim": round(fde_overlap, 4)}
        _phase(f"muvera-fde {hm['muvera_fde']}")
    except Exception as exc:
        detail["skipped"].append(f"muvera_fde_error:{type(exc).__name__}")
        _phase(f"muvera-fde failed: {exc}")

    # hybrid pipeline: overlap BEFORE MMR (MMR diversifies away from pure
    # top-10 by design), then the batched latency loop
    _phase("hybrid pipeline")
    results, _rr = hybrid_batch(0, qb)
    agree = [
        len({r.id for r in row[:10]} & {r.id for r in ex}) / 10
        for row, ex in zip(results, exact)
    ]
    hm["candidates"] = cand
    hm["overlap_at_10_vs_exact_maxsim"] = round(float(np.mean(agree)), 4)

    lat = []
    for i in range(4):
        lo = (i % 2) * qb  # rotate halves so no dispatch repeats its inputs
        t0 = time.perf_counter()
        hybrid_batch(lo, lo + qb)
        lat.append(time.perf_counter() - t0)
    lat_ms = min(lat) / qb * 1000
    hm["latency_ms_per_query"] = round(lat_ms, 2)
    hm["qps"] = round(1000.0 / lat_ms, 1)
    _phase(f"hybrid+maxsim+mmr {hm}")
    mv_col.close()


if __name__ == "__main__":
    main()
