#!/usr/bin/env python3
"""The edge kernels' fp32 tile height and the trained shape's hot rows,
measured on one CUDA card.

Run from the repository root:

    python3 scripts/edge_tile_sweep.py [--out FILE]

1. Launches: the inputs of every `edge_mpnn` launch of one served rung-8
   batch and every `edge_mpnn_runs` launch of one training forward of the
   §8 model (`chip_smoke.py`'s model, data and first training batch), with
   their E, K and M.
2. Heights: each of those launches timed (device µs per call,
   torch.profiler) at every fp32 tile height of 32 .. 128 edges
   (`edge_tile_sweep.cu` fixes the height) and through the shipped
   wrapper; then, for each set of at most three heights, the summed
   device time of one batch and one forward when each launch picks its
   height among that set by a per-call rule (`pick`), and when each takes
   its best height.
3. Hot rows: the trained `has_topic` conv (`chip_smoke.trained_inputs`)
   through both kernels as it is, with its longest run's targets spread
   over distinct rows, with its sources spread as well, and with every id
   drawn at random; each re-sorted by target.

Prints one JSON object (and writes it to --out); fails without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as smoke  # noqa: E402

ROWS = range(2, 9)  # tile heights in 16-edge row groups: 32 .. 128 edges
ACT_CODES = {"relu": 0, "gelu": 1, "identity": 2}


def build_sweep():
    """Compile edge_tile_sweep.cu with the kernels' flags; its entry."""
    from repro_torch.kernels import build
    src = os.path.join(ROOT, "scripts", "edge_tile_sweep.cu")
    out = build.BUILD_DIR / "edge_tile_sweep.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(out), src], capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"FAIL: nvcc {src}:\n{done.stdout}{done.stderr}")
    fn = ctypes.CDLL(str(out)).edge_tile_sweep_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_longlong] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def capture(torch, store, spec, first) -> list:
    """(library, inputs) of every edge kernel launch in one served rung-8
    batch and one training forward."""
    from repro_torch.core.graph_tensor import to_device
    from repro_torch.data.grouping import merge_and_pad
    from repro_torch.data.sampling import sample_subgraph, seed_rng
    from repro_torch.kernels import registry
    from repro_torch.kernels.edge_mpnn import kernel as mpnn
    from repro_torch.serve.gnn import GNNServer

    launches = []
    run = mpnn._run

    def spy(library, h_src, h_tgt, src, tgt, w, b, n_src, n_tgt, act, tile):
        launches.append((library, dict(
            h_src=h_src.clone(), h_tgt=h_tgt.clone(), src=src.clone(),
            tgt=tgt.clone(), w=w.clone(), b=b.clone(), n_src=n_src,
            n_tgt=n_tgt, act=act)))
        return run(library, h_src, h_tgt, src, tgt, w, b, n_src, n_tgt, act,
                   tile)

    model = smoke.build_model(torch, "sum")
    server = GNNServer(store, spec, model, device="cuda",
                       max_batch=smoke.MAX_BATCH, batch_window_ms=5.0)
    try:
        rng = np.random.default_rng(smoke.SEED + 1)
        roots = smoke.fresh_roots(rng, {0}, 8, store.num_nodes["paper"])
        graphs = [sample_subgraph(store, spec, r, seed_rng(0, r))
                  for r in roots]
        g = to_device(merge_and_pad(graphs, server.ladder.sizes[8]),
                      server.device)
        mpnn._run = spy
        with torch.inference_mode():
            model(g)
    finally:
        mpnn._run = run
        server.close()
    train_model = smoke.fresh_model(torch, "sum")
    mpnn._run = spy
    try:
        with registry.layout(sorted_by_target=True), torch.no_grad():
            train_model(first)
    finally:
        mpnn._run = run
    return launches


def sweep_call(torch, fn, runs: bool, rows: int, x: dict):
    """A call of the sweep entry at `rows` on launch inputs `x`."""
    m = x["w"].shape[1]
    out = torch.empty((x["n_tgt"], m), device="cuda")
    pieces = -(-x["src"].numel() // 32)  # carry.cuh scratch, any height
    carry = torch.empty(pieces * (4 + 2 * m), device="cuda")

    def call():
        rc = fn(int(runs), rows, x["h_src"].data_ptr(),
                x["h_tgt"].data_ptr(), x["src"].data_ptr(),
                x["tgt"].data_ptr(), x["w"].data_ptr(), x["b"].data_ptr(),
                out.data_ptr(), carry.data_ptr(), pieces,
                x["src"].numel(), x["n_src"], x["n_tgt"],
                x["h_src"].shape[1], x["h_tgt"].shape[1], x["w"].shape[1],
                ACT_CODES[x["act"]],
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"sweep launch failed with error {rc}")
    return call, out


def shipped_call(x: dict, library: str):
    from repro_torch.kernels.edge_mpnn import kernel as mpnn
    kernel = getattr(mpnn, library)
    return lambda: kernel(x["h_src"], x["h_tgt"], x["src"], x["tgt"],
                          x["w"], x["b"], n_src=x["n_src"],
                          n_tgt=x["n_tgt"], activation=x["act"])


def pick(e: int, m: int, sms: int, heights) -> int:
    """A per-call rule among `heights`: the fewest shared-memory loads on
    the busiest SM, (CTAs per SM, rounded up) x (rows + 4) per 16 k of an
    fp32 tile of 16 x rows edges; the lowest rows on a tie."""
    m_tiles = -(-m // 64)
    return min(heights, key=lambda r: (-(-(-(-e // (16 * r)) * m_tiles)
                                         // sms) * (r + 4), r))


def heights_phase(torch, fn, launches) -> dict:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows_out = []
    for library, x in launches:
        runs = library == "edge_mpnn_runs"
        want = shipped_call(x, library)()
        per_rows = {}
        for rows in ROWS:
            call, out = sweep_call(torch, fn, runs, rows, x)
            call()
            torch.cuda.synchronize()
            # the same sums in another tile order: fp32 atomics reorder
            err = float((out - want).abs().max())
            scale = float(want.abs().max()) + 1.0
            if not err <= 1e-4 * scale:
                raise SystemExit(f"FAIL: {library} E {x['src'].numel()} at "
                                 f"{16 * rows}-edge tiles: max err {err}")
            per_rows[rows] = smoke.device_per_call(torch, call)["device_us"]
        shipped = smoke.device_per_call(torch, shipped_call(x, library))
        e, m = x["src"].numel(), x["w"].shape[1]
        rows_out.append(dict(
            library=library, e=e, k=x["h_src"].shape[1] + x["h_tgt"].shape[1],
            m=m, n_src=x["n_src"], n_tgt=x["n_tgt"],
            valid=int((x["tgt"] < x["n_tgt"]).sum()),
            us_by_tile_edges={16 * r: us for r, us in per_rows.items()},
            shipped_us=shipped["device_us"]))
    totals = {}
    for library in ("edge_mpnn", "edge_mpnn_runs"):
        mine = [r for r in rows_out if r["library"] == library]
        by_set = {}
        for n in (1, 2, 3):
            for heights in itertools.combinations(ROWS, n):
                by_set[",".join(str(16 * h) for h in heights)] = sum(
                    r["us_by_tile_edges"][16 * pick(r["e"], r["m"], sms,
                                                    heights)] for r in mine)
        by_set["any of 32..128"] = sum(
            r["us_by_tile_edges"][16 * pick(r["e"], r["m"], sms, ROWS)]
            for r in mine)
        by_set["best per launch"] = sum(min(r["us_by_tile_edges"].values())
                                        for r in mine)
        totals[library] = dict(
            launches=len(mine), shipped_us=sum(r["shipped_us"]
                                               for r in mine),
            us_by_height_set=dict(sorted(by_set.items(),
                                         key=lambda kv: kv[1])))
    return dict(sms=sms, launches=rows_out, totals=totals)


def hot_rows_phase(torch, first) -> dict:
    """The trained conv as it is and with its hot rows spread."""
    t = smoke.trained_inputs(torch, first)
    src, tgt = t.src.long(), t.tgt.long()
    hot = int(torch.bincount(tgt, minlength=t.n_tgt + 1)[:t.n_tgt].argmax())
    idx = (tgt == hot).nonzero().flatten()
    spread = torch.arange(idx.numel(), device=tgt.device)
    gen = torch.Generator(device="cpu").manual_seed(smoke.SEED + 6)

    def draw(n, high):
        return torch.randint(0, high, (n,), generator=gen).to(tgt.device)

    variants = {"as is": (src, tgt)}
    tgt_spread = tgt.clone()
    tgt_spread[idx] = spread % t.n_tgt
    variants["long run's targets spread"] = (src, tgt_spread)
    src_spread = src.clone()
    src_spread[idx] = spread % t.n_src
    variants["targets and sources spread"] = (src_spread, tgt_spread)
    variants["every id random"] = (draw(t.e, t.n_src), draw(t.e, t.n_tgt))
    out = dict(e=t.e, n_src=t.n_src, n_tgt=t.n_tgt, hot_target=hot,
               long_run=idx.numel(),
               long_run_distinct_sources=int(src[idx].unique().numel()))
    from repro_torch.kernels.edge_mpnn import kernel as mpnn
    for name, (s, g) in variants.items():
        order = torch.argsort(g, stable=True)
        s, g = s[order].int().contiguous(), g[order].int().contiguous()
        row = {"distinct sources": int(s.unique().numel()),
               "longest run": int(torch.bincount(
                   g.long(), minlength=t.n_tgt + 1)[:t.n_tgt].max())}
        for kernel in (mpnn.edge_mpnn_runs, mpnn.edge_mpnn):
            row[kernel.__name__ + " us"] = smoke.device_per_call(
                torch, lambda: kernel(t.h_src, t.h_tgt, s, g, t.w, t.b,
                                      n_src=t.n_src, n_tgt=t.n_tgt)
            )["device_us"]
        out[name] = row
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: this script needs a CUDA card")
    smoke.full_fp32(torch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from repro_torch.kernels import build
    build.build(["edge_mpnn", "edge_mpnn_runs"])
    fn = build_sweep()
    raw, store, spec, setup, first = smoke.load_data()
    launches = capture(torch, store, spec, first)
    with torch.inference_mode():  # the served inputs are inference tensors
        heights = heights_phase(torch, fn, launches)
    result = dict(card=smi, heights=heights,
                  hot_rows=hot_rows_phase(torch, first))
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
