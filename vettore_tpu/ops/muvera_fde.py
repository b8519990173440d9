"""Device-side MUVERA FDE block: the candidate generator for fast
multi-vector (ColBERT MaxSim) search.

The exact full-corpus MaxSim scan is compute-bound — at 1M x 32 x 128
tokens, batch 64 x 32 query tokens, the dots alone are ~17 TFLOP/batch.
MUVERA (muvera.rs:26-74) compresses every token set to
ONE fixed-dimensional vector whose inner product approximates the chamfer
similarity, so candidate generation becomes a single [B, fde] x [fde, N]
matmul + top-C selection — two orders of magnitude fewer FLOPs — followed
by an exact MaxSim rerank of the C winners
(/root/reference/native/vettore/src/multi_vector.rs:90-132 semantics,
computed by ops/maxsim.maxsim_subset_topk_batch).

The document encoder here is the DEVICE counterpart of
ops/muvera.encode_documents: identical hash-derived SimHash weights and
Rademacher signs (ops/muvera._random_weights/_random_signs — bit-identical
to muvera.rs:203-216), the same query-sum / document-average semantics, but
the per-partition average is computed as an exact f32 segment mean in one
einsum instead of the reference's sequential running average — equal up to
f32 rounding order (~1e-7 relative), which is irrelevant for candidate
ranks. Public ``encode_document``/``encode_query`` keep the bit-exact host
path; this module only feeds the internal candidate generator.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import InvalidMuveraConfig
from . import muvera as host_muvera

#: candidate-selection metric family: FDE inner products approximate the
#: MaxSim similarity, which is the (clipped) dot for all three dot-family
#: metrics (multi_vector.rs:44-87)
FDE_METRICS = ("cosine", "inner_product", "negative_inner_product")

#: document chunk for the encoding sweep (bounds the [chunk, T, P] one-hot
#: and [chunk, T, pd] projection intermediates to a few hundred MB)
_ENC_CHUNK = 65_536


def default_config(dims: int) -> dict:
    """Internal-generator default: 16 SimHash partitions x 8 repetitions,
    projection to min(16, dims) — ~2048 FDE dims at d >= 16, enough for
    high top-C recall while the selection scan stays ~25x cheaper than the
    exact MaxSim sweep it replaces."""
    return {
        "dimension": dims,
        "num_repetitions": 8,
        "num_simhash_projections": 4,
        "projection_dimension": min(16, dims),
        "seed": 20_260_721,
    }


def normalize_config(config: dict | None, dims: int) -> dict:
    """Full MUVERA config validation (the host encoder's whitelist) for the
    candidate-generator path."""
    cfg = host_muvera._normalize_config(dict(config or {}), dims)
    return cfg


def config_key(cfg: dict) -> tuple:
    return tuple(cfg[k] for k in host_muvera.CONFIG_KEYS)


def fde_width(cfg: dict) -> int:
    full = (cfg["num_repetitions"] * (1 << cfg["num_simhash_projections"])
            * cfg["projection_dimension"])
    return cfg["final_projection_dimension"] or full


def padded_width(cfg: dict) -> int:
    """FDE width padded to a multiple of 128 — zero columns leave inner
    products unchanged and keep the selection matmul's width aligned."""
    w = fde_width(cfg)
    return -(-w // 128) * 128


def _rep_constants(cfg: dict):
    """Host-derived per-repetition hash constants (bit-identical to the
    reference's, ops/muvera.py): SimHash weight rows [reps, simhash, d] and
    Rademacher sign rows [reps, pd, d] (None in identity mode)."""
    dims = cfg["dimension"]
    reps = cfg["num_repetitions"]
    simhash = cfg["num_simhash_projections"]
    pd = cfg["projection_dimension"]
    seed = cfg["seed"]
    w = None
    if simhash:
        w = np.stack([
            np.stack([host_muvera._random_weights(seed, rep, p, dims)
                      for p in range(simhash)])
            for rep in range(reps)
        ]).astype(np.float32)  # [reps, simhash, d]
    s = None
    if pd != dims:
        sign_seed = (seed + 17) & host_muvera.U64_MAX
        s = np.stack([
            np.stack([host_muvera._random_signs(sign_seed, rep, p, dims)
                      for p in range(pd)])
            for rep in range(reps)
        ]).astype(np.float32)  # [reps, pd, d]
    return w, s


def _sketch_constants(cfg: dict):
    """Count-sketch slot/sign tables (muvera.rs:180-200 hashes)."""
    final = cfg["final_projection_dimension"]
    if final is None:
        return None, None
    full = (cfg["num_repetitions"] * (1 << cfg["num_simhash_projections"])
            * cfg["projection_dimension"])
    idx = np.arange(full, dtype=np.uint64)
    seed = cfg["seed"]
    slots = (host_muvera._hash4(np.uint64(seed), host_muvera._GOLDEN, idx,
                                np.uint64(0)) % np.uint64(final)).astype(np.int32)
    sign_hash = host_muvera._hash4(np.uint64(seed), host_muvera._SKETCH_SIGN,
                                   idx, slots.astype(np.uint64))
    signs = np.where((sign_hash & np.uint64(1)) == 0, np.float32(1.0),
                     np.float32(-1.0))
    return slots, signs


@functools.partial(
    jax.jit,
    static_argnames=("reps", "simhash", "pd", "identity", "final", "out_pad",
                     "out_dtype"))
def _encode_chunk(tokens, counts, w, s, sk_slots, sk_signs, *, reps, simhash,
                  pd, identity, final, out_pad, out_dtype):
    """One document chunk -> [chunk, out_pad] f32 FDEs (document mode:
    per-partition MEAN; empty partitions stay zero; zero-token docs encode
    to the zero vector, whose inner product is 0 — exactly their MaxSim
    score, multi_vector.rs:44-60)."""
    n, t, d = tokens.shape
    parts_count = 1 << simhash
    tok = tokens.astype(jnp.float32)
    mask = jnp.arange(t, dtype=jnp.int32)[None, :] < counts[:, None]  # [n, t]
    outs = []
    for rep in range(reps):
        if simhash:
            dots = jnp.einsum("ntd,sd->nts", tok, w[rep],
                              precision=jax.lax.Precision.HIGHEST,
                              preferred_element_type=jnp.float32)
            bits = (dots >= 0.0).astype(jnp.int32)
            powers = (1 << jnp.arange(simhash - 1, -1, -1, dtype=jnp.int32))
            parts = jnp.einsum("nts,s->nt", bits, powers)  # msb-first, as host
        else:
            parts = jnp.zeros((n, t), jnp.int32)
        onehot = (
            (parts[:, :, None] == jnp.arange(parts_count, dtype=jnp.int32)[None, None, :])
            & mask[:, :, None]
        ).astype(jnp.float32)  # [n, t, P]
        vals = tok if identity else jnp.einsum(
            "ntd,vd->ntv", tok, s[rep],
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)
        sums = jnp.einsum("ntp,ntv->npv", onehot, vals,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
        cnts = jnp.sum(onehot, axis=1)  # [n, P]
        mean = sums / jnp.maximum(cnts, 1.0)[:, :, None]
        outs.append(mean.reshape(n, parts_count * pd))
    out = jnp.concatenate(outs, axis=1) if len(outs) > 1 else outs[0]
    if final is not None:
        # count-sketch compression: signed scatter-add by hashed slot
        sketch = jnp.zeros((n, final), jnp.float32)
        out = sketch.at[:, sk_slots].add(sk_signs[None, :] * out)
    if out_pad > out.shape[1]:
        out = jnp.pad(out, ((0, 0), (0, out_pad - out.shape[1])))
    return out.astype(out_dtype)


@functools.partial(jax.jit, donate_argnums=0, static_argnums=2)
def _place_chunk(out, piece, offset):
    # donated in-place placement: the accumulating block never copies, so
    # peak HBM during a 1M encode is one block + one chunk (not two blocks)
    return jax.lax.dynamic_update_slice(out, piece, (offset, 0))


def encode_documents_device(tokens, counts, cfg: dict, out_dtype=jnp.float32):
    """Document FDEs of a resident ``[cap, T, d]`` token block:
    ``[cap, padded_width]`` device array in ``out_dtype``, chunked so
    intermediates stay bounded (each chunk casts to the storage dtype
    before placement — a full-width f32 block next to a 1M token block
    would double the block's device memory). Pad slots (count 0) encode to
    zero rows."""
    cap = int(tokens.shape[0])
    w, s = _rep_constants(cfg)
    w_dev = jnp.asarray(w) if w is not None else None
    s_dev = jnp.asarray(s) if s is not None else None
    sk_slots, sk_signs = _sketch_constants(cfg)
    sk_slots_dev = jnp.asarray(sk_slots) if sk_slots is not None else None
    sk_signs_dev = jnp.asarray(sk_signs) if sk_signs is not None else None
    kwargs = dict(
        reps=cfg["num_repetitions"],
        simhash=cfg["num_simhash_projections"],
        pd=cfg["projection_dimension"],
        identity=cfg["projection_dimension"] == cfg["dimension"],
        final=cfg["final_projection_dimension"],
        out_pad=padded_width(cfg),
        out_dtype=jnp.dtype(out_dtype).name,
    )
    if cap <= _ENC_CHUNK:
        return _encode_chunk(tokens, counts, w_dev, s_dev, sk_slots_dev,
                             sk_signs_dev, **kwargs)
    chunk = _ENC_CHUNK
    out = jnp.zeros((cap, kwargs["out_pad"]), out_dtype)
    for i in range(0, cap, chunk):
        step = min(chunk, cap - i)
        piece = _encode_chunk(
            jax.lax.dynamic_slice_in_dim(tokens, i, step, 0),
            jax.lax.dynamic_slice_in_dim(counts, i, step, 0),
            w_dev, s_dev, sk_slots_dev, sk_signs_dev, **kwargs)
        out = _place_chunk(out, piece, i)
    return out


def encode_query_sets_host(query_token_sets, cfg: dict) -> np.ndarray:
    """Query FDEs (sum mode) via the BIT-EXACT host encoder
    (ops/muvera.encode_queries ≡ muvera.rs query accumulation), padded to
    the device block's lane width. Query batches are small — the host cost
    is microseconds — and bit-exactness keeps the public encoder
    load-bearing on the serving path."""
    out = host_muvera.encode_queries(
        [np.asarray(ts, dtype=np.float64) for ts in query_token_sets], cfg)
    pad = padded_width(cfg)
    if out.shape[1] < pad:
        out = np.pad(out, ((0, 0), (0, pad - out.shape[1])))
    return out.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("count",))
def fde_candidates(fde, bias, qfde, *, count: int):
    """Top-``count`` candidate slots per query by FDE inner product
    (descending dot, (rank, slot) ties — slot order is lex id order): one
    matmul, then the exact group-cover selection of ``exact_top_c``.
    Returns ``(slots [B, count] i32, ok [B] bool)``.

    Selection-only: the query takes the block's dtype (bf16 for the
    collection's FDE block) with f32 accumulation and carries storage
    noise, like the flat bf16 scan; the winners are re-ranked by exact
    MaxSim downstream."""
    from .select import exact_top_c

    count = min(count, int(fde.shape[0]))
    dots = jnp.dot(qfde.astype(fde.dtype), fde.T,
                   preferred_element_type=jnp.float32)
    rank = -dots + bias[None, :]
    rank = jnp.where(jnp.isfinite(rank), rank, jnp.inf)
    slots, _keys, ok = exact_top_c(rank, None, c=count)
    return slots, ok


def validate_candidates(candidates) -> int:
    if (not isinstance(candidates, int) or isinstance(candidates, bool)
            or candidates <= 0):
        raise InvalidMuveraConfig("candidates must be a positive integer")
    return candidates
