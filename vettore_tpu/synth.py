"""Deterministic on-device synthetic corpus generation.

The reference generates its benchmark corpora host-side per run
(/root/reference/bench/search_modes_bench.exs:17-35 builds random unit
vectors in Elixir before timing). Uploading a 1M x 768 block from the
host costs far more than generating it where it is used, so this module
generates the SAME corpus geometry directly on device with counter-based
Threefry PRNG:

* **Deterministic**: same (shape, params, seed, backend) -> bit-identical
  block, every run. Callers can therefore keep a host-side canonical copy
  (downloaded once, disk-cached) and later *adopt* a freshly generated
  device block after sample verification (``FlatIndex.adopt_device_block``,
  ``Collection.adopt_token_block``) instead of re-uploading.
* **bf16-rounded f32**: every value is rounded to its nearest-even
  bfloat16-representable f32 (bit-for-bit the same rounding as
  ``ops.transport.round_to_bf16`` does on host), so any transport that IS
  needed ships 16-bit halves losslessly.

Nothing here is load-bearing for search semantics — collections ingest
whatever the caller provides; this is the framework's equivalent of a
dataset-synthesis utility, shared by the bench harness and scale tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def round_bf16_device(x):
    """Nearest-even bf16 rounding of an f32 device array, as explicit bit
    math so the result is bit-identical to the host-side
    ``ops.transport.round_to_bf16`` (same u32 arithmetic, no libm)."""
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    rounded = (
        bits + jnp.uint32(0x7FFF) + ((bits >> 16) & jnp.uint32(1))
    ) & jnp.uint32(0xFFFF0000)
    return jax.lax.bitcast_convert_type(rounded, jnp.float32)


def _unit_rows(x):
    return x / jnp.linalg.norm(x.astype(jnp.float32), axis=-1, keepdims=True)


@partial(jax.jit, static_argnums=(0, 1, 2))
def clustered(n: int, d: int, n_clusters: int, cluster_radius, seed):
    """``[n, d]`` unit vectors in Gaussian clusters (sigma =
    radius/sqrt(d)) — the bench's real-embedding-like geometry, generated
    on device. bf16-rounded f32; rows are unit-norm *before* rounding."""
    kc, ka, kn = jax.random.split(jax.random.PRNGKey(seed), 3)
    centers = _unit_rows(jax.random.normal(kc, (n_clusters, d), jnp.float32))
    assign = jax.random.randint(ka, (n,), 0, n_clusters)
    sigma = (jnp.float32(cluster_radius) / jnp.sqrt(jnp.float32(d)))
    data = centers[assign] + sigma * jax.random.normal(kn, (n, d), jnp.float32)
    return round_bf16_device(_unit_rows(data))


@partial(jax.jit, static_argnums=(0, 1))
def uniform_sphere(n: int, d: int, seed):
    """``[n, d]`` uniform unit vectors (no cluster structure) — the hard
    corpus for any routing/clustering index; used by recall sweeps."""
    k = jax.random.PRNGKey(seed)
    return round_bf16_device(
        _unit_rows(jax.random.normal(k, (n, d), jnp.float32)))


@partial(jax.jit, static_argnums=(1, 2, 3))
def token_block(docs, t: int, cap: int, t_max: int, token_noise, seed):
    """``[cap, t_max, d]`` multi-vector token block derived from ``docs``
    ([n, d]): each doc's ``t`` tokens are the doc vector plus Gaussian
    noise of norm ~``token_noise``, bf16-rounded; rows beyond ``n`` and
    token planes beyond ``t`` are zero (the padding layout
    ``Collection.adopt_token_block`` verifies)."""
    n, d = docs.shape
    noise = jnp.float32(token_noise) / jnp.sqrt(jnp.float32(d))
    k = jax.random.PRNGKey(seed)
    tok = docs.astype(jnp.float32)[:, None, :] + noise * jax.random.normal(
        k, (n, t, d), jnp.float32)
    tok = round_bf16_device(tok)
    out = jnp.zeros((cap, t_max, d), jnp.float32)
    return out.at[:n, :t].set(tok)


@partial(jax.jit, static_argnums=(1,))
def perturbed_queries(base, count: int, noise_norm, seed):
    """``[count, d]`` held-out queries: rows sampled from ``base`` plus
    noise at the cluster-radius norm, unit-normalized, bf16-rounded."""
    d = base.shape[1]
    ka, kn = jax.random.split(jax.random.PRNGKey(seed))
    pick = jax.random.randint(ka, (count,), 0, base.shape[0])
    sigma = jnp.float32(noise_norm) / jnp.sqrt(jnp.float32(d))
    q = base[pick].astype(jnp.float32) + sigma * jax.random.normal(
        kn, (count, d), jnp.float32)
    return round_bf16_device(_unit_rows(q))
