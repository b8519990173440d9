"""Host↔device transport helpers for bulk blocks.

The reference's NIF boundary moves Erlang terms in-process
(/root/reference/native/vettore/src/nifs.rs) — transfer cost is negligible
there. Here every block crosses the host↔device link, so bulk uploads of
bf16-representable data ship at half size:

* **u16 transport for bf16-representable f32 blocks** (`put_f32_matrix`):
  when every value's low mantissa half is zero (true for any data that ever
  passed through bfloat16, and for synthetic corpora rounded at generation),
  the block ships as the high 16 bits only — half the bytes — and is
  reconstructed bit-exactly on device. Lossless, so API semantics are
  unchanged; blocks that fail the check ship as plain f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def is_bf16_exact(mat: np.ndarray) -> bool:
    """True when every f32 value is exactly representable in bfloat16 (low
    16 mantissa bits all zero) — the lossless-u16-transport precondition."""
    if mat.dtype != np.float32:
        return False
    view = mat.view(np.uint32)
    return bool((view & np.uint32(0xFFFF) == 0).all())


def round_to_bf16(mat: np.ndarray) -> np.ndarray:
    """Rounds an f32 array to its nearest-even bf16-representable value
    (for data generators that opt into compact transport)."""
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    bits = mat.view(np.uint32)
    # round-to-nearest-even on the high half
    rounded = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return rounded.view(np.float32)


@jax.jit
def _expand_u16(halves):
    return jax.lax.bitcast_convert_type(
        halves.astype(jnp.uint32) << 16, jnp.float32
    )


def put_f32_matrix(mat: np.ndarray, *, allow_u16: bool = True):
    """Uploads an f32 host matrix to the default device. Ships 16-bit halves
    when the data is bf16-exact (bit-identical reconstruction on device)."""
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    if allow_u16 and mat.size and is_bf16_exact(mat):
        halves = (mat.view(np.uint32) >> 16).astype(np.uint16)
        return _expand_u16(jnp.asarray(halves))
    return jnp.asarray(mat)


@jax.jit
def _halves_to_bf16(halves):
    return jax.lax.bitcast_convert_type(halves, jnp.bfloat16)


@jax.jit
def _to_u16_halves(x):
    return (jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
            >> 16).astype(jnp.uint16)


def get_f32_matrix(x_dev) -> np.ndarray:
    """Downloads a bf16-exact f32 (or bf16) device array as 16-bit halves —
    half the bytes of a plain ``device_get`` — and widens on host,
    bit-exactly. The inverse of :func:`put_f32_matrix`'s u16 path; only
    valid for data known bf16-exact (e.g. ``vettore_tpu.synth`` output)."""
    halves = np.asarray(jax.device_get(_to_u16_halves(x_dev)))
    return (halves.astype(np.uint32) << 16).view(np.float32)


def put_token_block(block: np.ndarray):
    """Uploads a multi-vector token block, keeping it **bfloat16-resident**
    when that is lossless: a bf16 value's bit pattern IS the high half of its
    f32 pattern, so bf16-exact data ships as u16 and bitcasts straight to a
    bf16 device array — half the link bytes AND half the device memory, with zero f32
    intermediate (a [1M, 32, 128] corpus never exists as 16 GB on device).
    Non-exact data uploads as plain f32 (full fidelity, full size)."""
    block = np.ascontiguousarray(block, dtype=np.float32)
    if block.size and is_bf16_exact(block):
        halves = (block.view(np.uint32) >> 16).astype(np.uint16)
        return _halves_to_bf16(jnp.asarray(halves))
    return jnp.asarray(block)
