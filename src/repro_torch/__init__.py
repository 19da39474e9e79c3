"""repro_torch — the PyTorch/CUDA port of `repro`, grown slice by slice.

The layout mirrors `repro` module for module, so each port module sits
where its reference does (`repro.core.ops` -> `repro_torch.core.ops`).
The package imports torch and numpy only: never jax, never `repro`.  Host
code it needs from `repro` (schema, sampling, batching, caches) is kept
as its own copy, held to the original by the parity tests.

Device rule: entry points run on CUDA unless the caller passes
``device="cpu"``.  On a CUDA tensor every kernel wrapper launches its
hand-written Hopper kernel (built from the `.cu` sources beside it at
first use); on a CPU tensor it runs the plain PyTorch version of the same
function.  A failed build or launch raises — nothing falls back.
"""
