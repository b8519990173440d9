"""On-device corpus synthesis (vettore_tpu/synth.py) and the
adopt-device-block fast paths (FlatIndex.adopt_device_block,
Collection.adopt_token_block).

The adopt APIs exist because a deterministic generator re-creates a block
on device far faster than the host can upload it; the canonical data ALWAYS stays in the host store (the
reference's store-vs-acceleration invariant, README.md:410-415), and
adoption only succeeds after sampled rows verify bit-identical."""

import numpy as np
import pytest

import jax.numpy as jnp

from vettore_tpu import errors as E, synth
from vettore_tpu.collection import Collection
from vettore_tpu.errors import (
    DimensionMismatch, InvalidFlatOptions, InvalidVector)
from vettore_tpu.index.flat import FlatIndex
from vettore_tpu.ops.transport import is_bf16_exact, round_to_bf16


# ---------------------------------------------------------------------------
# synth generators
# ---------------------------------------------------------------------------


def test_clustered_deterministic_and_bf16_exact():
    a = np.asarray(synth.clustered(500, 32, 16, 0.4, 7))
    b = np.asarray(synth.clustered(500, 32, 16, 0.4, 7))
    assert a.dtype == np.float32
    assert (a.view(np.uint32) == b.view(np.uint32)).all()
    assert is_bf16_exact(a)
    # unit rows before rounding -> norms within bf16 rounding of 1
    assert np.abs(np.linalg.norm(a, axis=1) - 1.0).max() < 0.05
    c = np.asarray(synth.clustered(500, 32, 16, 0.4, 8))
    assert (a.view(np.uint32) != c.view(np.uint32)).any()


def test_uniform_sphere_deterministic():
    a = np.asarray(synth.uniform_sphere(256, 24, 3))
    b = np.asarray(synth.uniform_sphere(256, 24, 3))
    assert (a.view(np.uint32) == b.view(np.uint32)).all()
    assert is_bf16_exact(a)
    # no cluster structure: mean pairwise |cos| stays small
    sims = a @ a.T - np.eye(256)
    assert np.abs(sims).mean() < 0.2


def test_round_bf16_device_matches_host_rounding():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 33)).astype(np.float32) * 3.7
    dev = np.asarray(synth.round_bf16_device(jnp.asarray(x)))
    host = round_to_bf16(x)
    assert (dev.view(np.uint32) == host.view(np.uint32)).all()


def test_perturbed_queries_shape_and_determinism():
    base = synth.clustered(200, 16, 8, 0.4, 1)
    q1 = np.asarray(synth.perturbed_queries(base, 32, 0.4, 5))
    q2 = np.asarray(synth.perturbed_queries(base, 32, 0.4, 5))
    assert q1.shape == (32, 16)
    assert (q1.view(np.uint32) == q2.view(np.uint32)).all()
    assert is_bf16_exact(q1)


def test_get_f32_matrix_roundtrip():
    from vettore_tpu.ops.transport import get_f32_matrix

    dev = synth.clustered(64, 24, 4, 0.4, 13)
    host = get_f32_matrix(dev)
    assert (host.view(np.uint32) == np.asarray(dev).view(np.uint32)).all()
    # bf16-resident arrays download identically
    host16 = get_f32_matrix(dev.astype(jnp.bfloat16))
    assert (host16.view(np.uint32) == host.view(np.uint32)).all()


def test_token_block_layout():
    docs = synth.clustered(50, 16, 4, 0.4, 2)
    cap, t, t_max = 64, 3, 4
    blk = np.asarray(synth.token_block(docs, t, cap, t_max, 0.3, 9))
    assert blk.shape == (cap, t_max, 16)
    assert is_bf16_exact(blk)
    assert (blk[50:] == 0).all() and (blk[:, t:] == 0).all()
    assert (blk[:50, :t] != 0).any()


# ---------------------------------------------------------------------------
# FlatIndex.adopt_device_block
# ---------------------------------------------------------------------------


def _flat_with(data):
    f = FlatIndex("cosine")
    f.put_matrix([f"r-{i:05d}" for i in range(data.shape[0])], data)
    return f


def test_adopt_device_block_matches_upload_path():
    dev = synth.clustered(300, 24, 8, 0.4, 21)
    host = np.asarray(dev)
    q = np.asarray(synth.perturbed_queries(dev, 8, 0.4, 22))

    a = _flat_with(host)
    a.adopt_device_block(dev)
    assert not a._dirty and a._device is not None
    b = _flat_with(host)
    b._sync_device()

    ha = a.search_batch(q, 10)
    hb = b.search_batch(q, 10)
    assert [[(i, s) for i, s in row] for row in ha] == [
        [(i, s) for i, s in row] for row in hb]


def test_adopt_device_block_accepts_cap_padded_block():
    dev = synth.clustered(100, 16, 4, 0.4, 31)
    host = np.asarray(dev)
    f = _flat_with(host)
    padded = jnp.zeros((f._cap, 16), jnp.float32).at[:100].set(dev)
    f.adopt_device_block(padded)
    hits = f.search_batch(host[:2], 3)
    assert hits[0][0][0] == "r-00000"


def test_adopt_device_block_rejects_mismatch():
    dev = synth.clustered(120, 16, 4, 0.4, 41)
    host = np.asarray(dev)
    f = _flat_with(host)
    with pytest.raises(InvalidVector):
        f.adopt_device_block(dev.at[7, 3].add(0.25), sample=120)
    # rejection leaves the normal upload path intact
    f._sync_device()
    assert f.search_batch(host[:1], 1)[0][0][0] == "r-00000"


def test_adopt_device_block_validation():
    dev = synth.clustered(60, 16, 4, 0.4, 51)
    f = _flat_with(np.asarray(dev))
    with pytest.raises(DimensionMismatch):
        f.adopt_device_block(jnp.zeros((60, 17), jnp.float32))
    with pytest.raises(InvalidVector):
        f.adopt_device_block(dev.astype(jnp.bfloat16))
    with pytest.raises(InvalidVector):
        f.adopt_device_block(jnp.zeros((f._cap + 8, 16), jnp.float32))
    empty = FlatIndex("cosine")
    with pytest.raises(InvalidFlatOptions):
        empty.adopt_device_block(jnp.zeros((4, 4), jnp.float32))


def test_adopt_device_block_bf16_storage_view():
    """The adopted block feeds every storage view the same way the uploaded
    one does (the view re-derives bf16/int8 from the adopted f32 block)."""
    dev = synth.clustered(200, 16, 4, 0.4, 61)
    host = np.asarray(dev)
    q = host[:4]
    a = _flat_with(host)
    a.adopt_device_block(dev)
    b = _flat_with(host)
    va, vb = a.storage_view("bf16"), b.storage_view("bf16")
    assert [[(i, s) for i, s in r] for r in va.search_batch(q, 5)] == [
        [(i, s) for i, s in r] for r in vb.search_batch(q, 5)]


# ---------------------------------------------------------------------------
# Collection.adopt_token_block
# ---------------------------------------------------------------------------


def _mv_collection(n=80, t=4, d=16, seed=71):
    """normalize='none': cosine scoring is norm-invariant, and with no
    insert-time renormalization the stored token rows stay bit-identical
    to the generator output — the precondition for adopting a regenerated
    device block (l2-normalized stores correctly refuse raw blocks)."""
    docs = synth.clustered(n, d, 4, 0.4, seed)
    cap = 128  # _cap_at_least(80) on the pow2 branch
    blk = synth.token_block(docs, t, cap, t, 0.3, seed + 1)
    host_tokens = np.asarray(blk)[:n, :t]
    col = Collection(name="mv", dimensions=d, metric="cosine", index="flat",
                     normalize="none")
    col.put_tokens([f"m-{i:04d}" for i in range(n)], host_tokens)
    return col, blk, host_tokens, docs


def test_adopt_token_block_matches_upload_path():
    col, blk, host_tokens, docs = _mv_collection()
    cache = col._scan_cache()
    blk = jnp.zeros((cache.cap,) + blk.shape[1:], jnp.float32).at[
        : blk.shape[0]].set(blk)
    col.adopt_token_block(blk)

    ref = Collection(name="mv2", dimensions=16, metric="cosine", index="flat",
                     normalize="none")
    ref.put_tokens([f"m-{i:04d}" for i in range(host_tokens.shape[0])],
                   host_tokens)
    q = [list(r) for r in host_tokens[5]]
    ha = col.multi_vector_search(q, limit=6)
    hb = ref.multi_vector_search(q, limit=6)
    assert [(r.id, r.score) for r in ha] == [(r.id, r.score) for r in hb]


def test_adopt_token_block_bf16_resident():
    col, blk, host_tokens, _ = _mv_collection(seed=81)
    cache = col._scan_cache()
    blk = jnp.zeros((cache.cap,) + blk.shape[1:], jnp.float32).at[
        : blk.shape[0]].set(blk).astype(jnp.bfloat16)
    col.adopt_token_block(blk)
    q = [list(r) for r in host_tokens[3]]
    hits = col.multi_vector_search(q, limit=3)
    assert hits[0].id == "m-0003"


def test_adopt_token_block_rejections():
    col, blk, host_tokens, _ = _mv_collection(seed=91)
    cache = col._scan_cache()
    full = jnp.zeros((cache.cap,) + blk.shape[1:], jnp.float32).at[
        : blk.shape[0]].set(blk)
    with pytest.raises(E.InvalidMultiVector):  # wrong shape
        col.adopt_token_block(full[:, :2])
    with pytest.raises(E.InvalidMultiVector):  # tampered content
        col.adopt_token_block(full.at[11, 1, 2].add(0.5), sample=80)
    with pytest.raises(E.InvalidMultiVector):  # nonzero padding row
        col.adopt_token_block(full.at[cache.n].add(1.0))
    with pytest.raises(E.InvalidMultiVector):  # wrong dtype
        col.adopt_token_block(full.astype(jnp.float16))
    empty = Collection(name="e", dimensions=16, metric="cosine", index="flat")
    with pytest.raises(E.InvalidMultiVector):
        empty.adopt_token_block(full)
    # non-uniform (per-record list) corpora refuse adoption
    ragged = Collection(name="rg", dimensions=16, metric="cosine", index="flat")
    ragged.put_many([
        {"id": "a", "vectors": [[0.5] * 16, [0.25] * 16]},
        {"id": "b", "vectors": [[0.125] * 16]},
    ])
    with pytest.raises(E.InvalidMultiVector):
        ragged.adopt_token_block(jnp.zeros((8, 2, 16), jnp.float32))


def test_adopt_token_block_invalidated_by_mutation():
    """An adopted block lives one cache generation: any mutation rebuilds
    the scan cache from the canonical store."""
    col, blk, host_tokens, _ = _mv_collection(seed=101)
    cache = col._scan_cache()
    full = jnp.zeros((cache.cap,) + blk.shape[1:], jnp.float32).at[
        : blk.shape[0]].set(blk)
    col.adopt_token_block(full)
    col.put({"id": "zz-new", "vectors": [list(host_tokens[0, 0])]})
    hits = col.multi_vector_search([list(host_tokens[0, 0])], limit=2)
    assert "zz-new" in {r.id for r in hits}
