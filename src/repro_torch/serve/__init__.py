"""repro_torch.serve — GNN inference serving on the GPU (counterpart of
`repro.serve`, GNN half).

  * ``repro_torch.serve.gnn``     — the request path (`repro.serve.gnn`):
    on-demand seeded subgraph sampling, micro-batching into a fixed
    bucket ladder of padded SizeConstraints, and one forward per bucket
    captured as a CUDA graph at warmup and replayed per batch (the
    counterpart of the reference's per-bucket compiled forward,
    `repro/serve/gnn.py:280-282,307-334`);
  * ``repro_torch.serve.cache``   — the versioned GraphStore and the
    subgraph / node-embedding caches (a copy of `repro.serve.cache`);
  * ``repro_torch.serve.loadgen`` — closed- and open-loop load generation
    (a copy of `repro.serve.loadgen`).

PEP 562 lazy exports, mirroring `repro/serve/__init__.py:20-37`:
importing the package imports neither torch nor any symbol's module —
the symbol's home module loads on first attribute access, so
``repro_torch.serve.loadgen`` and ``repro_torch.serve.cache`` stay
numpy-only.
"""
from __future__ import annotations

_EXPORTS = {
    "GNNServer": "repro_torch.serve.gnn",
    "BucketLadder": "repro_torch.serve.gnn",
    "build_ladder": "repro_torch.serve.gnn",
    "spec_size_bounds": "repro_torch.serve.gnn",
    "ServeRequest": "repro_torch.serve.gnn",
    "ServeError": "repro_torch.serve.gnn",
    "EngineClosed": "repro_torch.serve.gnn",
    "VersionedGraphStore": "repro_torch.serve.cache",
    "VersionedLRUCache": "repro_torch.serve.cache",
    "SubgraphCache": "repro_torch.serve.cache",
    "CacheStats": "repro_torch.serve.cache",
    "closed_loop": "repro_torch.serve.loadgen",
    "open_loop": "repro_torch.serve.loadgen",
    "LoadReport": "repro_torch.serve.loadgen",
    # `ServeEngine` and `Request` (the LM continuous-batching engine,
    # `repro.serve.engine`) join this map with the LM side stack,
    # ROADMAP.md queue 1 item 2.
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module_name = _EXPORTS.get(name)
    if module_name is None:
        raise AttributeError(f"module 'repro_torch.serve' has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(module_name), name)


def __dir__():
    return __all__
