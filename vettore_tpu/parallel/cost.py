"""Falsifiable cost model for the interconnect candidate merges (SURVEY §5.8).

The sharded search programs merge per-shard top-k candidate sets with
``all_gather`` over the ``shard`` axis. This module states the expected
per-chip gather traffic in bytes and verifies it against the program the
compiler actually sees, by walking the traced jaxpr for ``all_gather``
equations. The driver's multi-chip dryrun asserts the two agree, so the
merge design carries a checkable cost model for any interconnect.

Model (``vettore_tpu/parallel/mesh.py::sharded_search``): each shard emits
``k`` candidate triples per query as four planes — rank f32, lex-rank i32,
global slot i32, raw f32 — so one query batch of local size ``b`` moves

    bytes/chip = 4 planes * b * (S * k) * 4 B

through the interconnect (each device materializes the gathered
``[b, S*k]`` planes).
"""

from __future__ import annotations

import jax


def expected_merge_bytes(n_shards: int, b_local: int, k: int,
                         planes: int = 4, itemsize: int = 4) -> int:
    """Modelled per-device interconnect bytes for one sharded top-k merge."""
    return planes * b_local * n_shards * k * itemsize


def _walk(jaxpr, out):
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)  # ClosedJaxpr -> Jaxpr
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "all_gather":
            for v in eqn.outvars:
                aval = v.aval
                out.append(int(aval.size) * aval.dtype.itemsize)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            _walk(sub, out)
    return out


def traced_allgather_bytes(fn, *args, **kwargs) -> int:
    """Sum of all_gather output bytes (per chip) in ``fn``'s jaxpr."""
    jaxpr = jax.make_jaxpr(lambda *a: fn(*a, **kwargs))(*args)
    return sum(_walk(jaxpr.jaxpr, []))
