"""vettore-tpu: an accelerator vector search framework in JAX.

A brand-new JAX/XLA/Pallas implementation of the capabilities of
elchemista/vettore (in-memory vector collections with exact flat search, HNSW
ANN, Matryoshka funnel staging, binary-quantized candidates, ColBERT MaxSim
late interaction, MUVERA fixed-dimensional encodings, hybrid pipelines, MMR
reranking, and checksummed snapshots) — redesigned for an accelerator:
vectors live in device-resident blocks, scans run as fused matmul + top-k
programs, and collections larger than one device shard across a
``jax.sharding.Mesh``.

Quick start::

    import vettore_tpu as vt

    col = vt.Collection(name="docs", dimensions=3, index="flat",
                        metric="cosine", normalize="l2")
    col.put_many([
        {"id": "east", "vector": [1.0, 0.0, 0.0], "metadata": {"kind": "axis"}},
        {"id": "north", "vector": [0.0, 1.0, 0.0]},
    ])
    results = col.search([1.0, 0.0, 0.0], limit=2)
"""

import os as _os

import jax as _jax

#: the checkout's own persistent compile cache (listed in .gitignore)
_CHECKOUT_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache")


def _compile_cache_dir(environ=_os.environ):
    """Where this package points JAX's persistent compile cache: None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX honours it by itself), else
    the checkout's fixed ``.jax_cache/`` — a fixed path, because the path is
    part of the cache key."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _CHECKOUT_CACHE


if _compile_cache_dir() is not None:
    _jax.config.update("jax_compilation_cache_dir", _compile_cache_dir())

from . import distance, errors, multi_vector, muvera, observability
from .collection import Collection, load_snapshot
from .compat import DB
from .embedding import Embedding, Result
from .index.flat import FlatIndex
from .index.hnsw import HnswIndex
from .metrics import METRICS, metric_code, normalize_metric, result_values
from .ops.scan_host import binary_top_k, vector_top_k
from .store.memory import MemoryStore

__version__ = "0.1.0"

__all__ = [
    "Collection",
    "DB",
    "load_snapshot",
    "Embedding",
    "Result",
    "FlatIndex",
    "HnswIndex",
    "MemoryStore",
    "METRICS",
    "metric_code",
    "normalize_metric",
    "result_values",
    "vector_top_k",
    "binary_top_k",
    "distance",
    "multi_vector",
    "muvera",
    "observability",
    "errors",
    "__version__",
]
