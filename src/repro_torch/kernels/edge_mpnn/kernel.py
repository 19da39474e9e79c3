"""edge_mpnn and edge_mpnn_runs: the wrappers of the hand-written Hopper
kernels in `edge_mpnn.cu` and `edge_mpnn_runs.cu` (ports of the Pallas
kernels `edge_mpnn` and `edge_mpnn_runs` in
src/repro/kernels/edge_mpnn/kernel.py).

Both take the same arguments and compute the same function; the run
variant scatters once per run of equal targets, which pays on
target-sorted edges (the training batches).  On a CUDA tensor a wrapper
launches its kernel, at any message width — it checks device, dtype,
shape and contiguity and raises on what the kernel does not take; on a
CPU tensor it runs the plain version in `ref.py`.  Each wrapper's
`launches` counts its kernel launches (plain-version calls are not
counted).

One call is one ctypes call: the C entry zeroes the fp32 accumulator with
a memset and launches the kernel (the tile product of `edge_mma.cuh`:
fp32 FMAs in the plain version's k order, or bf16/fp16 on the tensor
cores), plus one cast kernel for a 16-bit output.  For fp32 the
accumulator is the output itself, so an fp32 `edge_mpnn` call allocates
one tensor and runs one kernel.  `edge_mpnn_runs` also takes a carry
scratch and runs a second kernel that adds the runs crossing an edge
tile in tile order (`carry.cuh`): on target-sorted edges its result is
bit-identical from call to call.

The tile height is a run-time argument of both C entries: fp32 tiles of
32, 64 or 128 edges, 16-bit tiles of 64 (`tiles`; 0 is the default, 32
for fp32), which `kernels/autotune.py` times per shape and the registry
passes from its record.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.edge_mpnn.ref import ACTIVATIONS, edge_mpnn_ref

_ACT_CODES = {"relu": 0, "gelu": 1, "identity": 2}
# edges of the run kernel's smallest tile (edge_mma.cuh: 32 for fp32, 64
# for 16-bit), so ceil(E / 32) carry pieces cover any dtype and tile
_RUN_TILE_EDGES = 32
# the tile heights in edges each dtype's kernels are built for
# (edge_mma.cuh tile_rows)
_FP32_TILES = (32, 64, 128)
_16BIT_TILES = (64,)


def tiles(library: str, dtype: torch.dtype, width: int) -> tuple:
    """The tile heights, in edges, kernel `library` is built for at this
    dtype (besides 0, its default): what a tuner may time and a record
    may name.  Both edge kernels take the same heights at any width."""
    del library, width
    return _FP32_TILES if dtype == torch.float32 else _16BIT_TILES


@functools.cache
def _entry(library: str):
    fn = getattr(build.load(library), f"{library}_launch")
    # h_src, h_tgt, src, tgt, w, b, acc, out, [carry, carry_pieces,]
    # e, n_src, n_tgt, ds, dt, m, dtype, act, tile, stream
    carry = ([ctypes.c_void_p, ctypes.c_longlong]
             if library == "edge_mpnn_runs" else [])
    fn.argtypes = ([ctypes.c_void_p] * 8 + carry + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(library: str, name: str, t: torch.Tensor, ndim: int,
           device) -> None:
    if t.ndim != ndim or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{library} kernel: {name} must be a contiguous "
                         f"{ndim}-D tensor on {device}, got shape "
                         f"{tuple(t.shape)} on {t.device}")


def _run(library: str, h_src, h_tgt, src, tgt, w, b, n_src: int,
         n_tgt: int, activation: str, tile: int):
    """Check the inputs and launch kernel `library`; returns (out,
    launched)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}; "
                         f"expected one of {ACTIVATIONS}")
    if tile:
        built = tiles(library, h_src.dtype, w.shape[-1])
        if tile not in built:
            raise ValueError(f"{library} kernel: no {tile}-edge tile for "
                             f"{h_src.dtype} (built: {built})")
    if not h_src.is_cuda:
        return edge_mpnn_ref(h_src, h_tgt, src, tgt, w, b, n_src=n_src,
                             n_tgt=n_tgt, activation=activation), False
    device = h_src.device
    for name, t, ndim in (("h_src", h_src, 2), ("h_tgt", h_tgt, 2),
                          ("w", w, 2), ("b", b, 1), ("src", src, 1),
                          ("tgt", tgt, 1)):
        _check(library, name, t, ndim, device)
    if len({h_src.dtype, h_tgt.dtype, w.dtype, b.dtype}) != 1:
        raise TypeError(f"{library} kernel: h_src, h_tgt, w and b must "
                        "share one dtype")
    if src.dtype != torch.int32 or tgt.dtype != torch.int32 \
            or src.shape != tgt.shape:
        raise TypeError(f"{library} kernel: src/tgt must be int32 [E]")
    ds, dt, m = h_src.shape[1], h_tgt.shape[1], w.shape[1]
    if (h_src.shape[0] != n_src or h_tgt.shape[0] != n_tgt
            or w.shape[0] != ds + dt or b.shape[0] != m):
        raise ValueError(f"{library} kernel: inconsistent shapes")
    if m == 0:
        raise ValueError(f"{library} kernel: message width 0")
    e = src.shape[0]
    if e and n_src == 0:
        raise ValueError(f"{library} kernel: edges with no source nodes")
    # padding edges carry tgt = n_tgt, which must fit int32 as well
    build.check_int32(library, edges=e, n_src=n_src, n_tgt=n_tgt + 1,
                      width=ds + dt)
    code = build.dtype_code(h_src)
    out = torch.empty((n_tgt, m), dtype=h_src.dtype, device=device)
    if out.numel() == 0:
        return out, False  # nothing to launch
    acc = out if out.dtype == torch.float32 else torch.empty(
        (n_tgt, m), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    args = [h_src.data_ptr(), h_tgt.data_ptr(), src.data_ptr(),
            tgt.data_ptr(), w.data_ptr(), b.data_ptr(), acc.data_ptr(),
            out.data_ptr()]
    if library == "edge_mpnn_runs":
        # the carry scratch of carry.cuh: [pieces] int4 meta, then
        # [pieces, 2, m] fp32 partials; every tile writes its own meta
        pieces = -(-e // _RUN_TILE_EDGES)
        carry = torch.empty(pieces * (4 + 2 * m), dtype=torch.float32,
                            device=device)
        args += [carry.data_ptr(), pieces]
    rc = _entry(library)(*args, e, n_src, n_tgt, ds, dt, m, code,
                         _ACT_CODES[activation], tile, stream)
    build.check_launch(rc, library)
    return out, True


def edge_mpnn(h_src: torch.Tensor, h_tgt: torch.Tensor, src: torch.Tensor,
              tgt: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
              n_src: int, n_tgt: int, activation: str = "relu",
              tile: int = 0) -> torch.Tensor:
    """h_src [n_src, Ds], h_tgt [n_tgt, Dt], src/tgt [E] int32 (padding
    edges carry tgt >= n_tgt), w [Ds+Dt, M], b [M] -> [n_tgt, M] in the
    inputs' dtype.  `tile`: edges a tile, one of `tiles(...)`, or 0 for
    the default."""
    out, launched = _run("edge_mpnn", h_src, h_tgt, src, tgt, w, b, n_src,
                         n_tgt, activation, tile)
    if launched:
        edge_mpnn.launches += 1
    return out


def edge_mpnn_runs(h_src: torch.Tensor, h_tgt: torch.Tensor,
                   src: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, *, n_src: int, n_tgt: int,
                   activation: str = "relu",
                   tile: int = 0) -> torch.Tensor:
    """The run variant: same contract as `edge_mpnn`, one add per run of
    equal targets in an edge tile and one per chain of runs that cross
    tiles, folded in tile order.  Correct for any edge order; fastest, and
    bit-repeatable, when tgt is sorted."""
    out, launched = _run("edge_mpnn_runs", h_src, h_tgt, src, tgt, w, b,
                         n_src, n_tgt, activation, tile)
    if launched:
        edge_mpnn_runs.launches += 1
    return out


edge_mpnn.launches = 0
edge_mpnn_runs.launches = 0
