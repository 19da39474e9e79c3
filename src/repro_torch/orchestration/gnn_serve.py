"""Low-latency GNN inference serving, end to end (the port's twin of
`examples/gnn_serve.py`).

Stands up a `GNNServer` over synthetic MAG — on-demand seeded subgraph
sampling, dynamic micro-batching into a warmed bucket ladder (one CUDA
graph per rung on the card), versioned subgraph + node-embedding caches
— then drives it the three ways the example does: synchronous queries, a
closed-loop client fleet, and an open-loop (seeded-Poisson) arrival
schedule at half the closed loop's QPS (at least 20).  Finishes with the
freshness story: mutating the graph bumps the store version, stale cache
entries are evicted, and re-served queries resample.

The defaults are the example's: 600 papers, 32 wide, `cites` sampled 8
then 4, a 2-round `vanilla_mpnn`, 4 clients x 25 requests, a 1 s open
loop, `max_batch` 8.  Exits non-zero on any load error or steady-state
recompile.  Runs on CUDA unless asked for the CPU (``--device cpu``):

    PYTHONPATH=src python -m repro_torch.orchestration.gnn_serve
    PYTHONPATH=src python -m repro_torch.orchestration.gnn_serve --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch import nn

from repro_torch.core.graph_tensor import HIDDEN_STATE, resolve_device
from repro_torch.core.models import vanilla_mpnn
from repro_torch.core.schema import mag_schema
from repro_torch.data.sampling import SamplingSpecBuilder
from repro_torch.data.synthetic import synthetic_mag
from repro_torch.nn.layers import Linear, init_params, load_jax_params
from repro_torch.orchestration.tasks import RootNodeMulticlassClassification
from repro_torch.serve.cache import VersionedGraphStore
from repro_torch.serve.gnn import GNNServer, ServeSnapshot, spec_size_bounds
from repro_torch.serve.loadgen import LoadReport, closed_loop, open_loop

PAPERS, CLIENTS, REQUESTS_PER_CLIENT, OPEN_LOOP_S, MAX_BATCH = \
    600, 4, 25, 1.0, 8
DIM, N_CLASSES, FEAT_DIM, ROUNDS = 32, 8, 32, 2


def sampling_spec(schema):
    """The example's 2-hop citation neighbourhoods: `cites` 8 then 4."""
    b = SamplingSpecBuilder(schema)
    seed_op = b.seed("paper")
    seed_op.sample(8, "cites").sample(4, "cites")
    return seed_op.build()


def problem(papers: int = PAPERS) -> tuple:
    """(versioned store, sampling spec) of the example over synthetic
    MAG."""
    raw, _ = synthetic_mag(n_papers=papers, n_authors=papers // 2,
                           n_institutions=20, n_fields=40,
                           n_classes=N_CLASSES, feat_dim=FEAT_DIM)
    store = VersionedGraphStore.wrap(raw)
    return store, sampling_spec(store.schema)


class ServeModel(nn.Module):
    """The example's model: init states (`Linear(32, dim)` + relu) -> a
    2-round `vanilla_mpnn` over `cites` -> root-node head.  Parameter
    names follow the example's tree (``init``, ``gnn``, ``head``)."""

    def __init__(self, dim: int = DIM):
        super().__init__()
        self.init = Linear(FEAT_DIM, dim)
        self.gnn = vanilla_mpnn({"cites": ("paper", "paper")},
                                {"paper": dim}, message_dim=dim,
                                hidden_dim=dim, num_rounds=ROUNDS)
        self.task = RootNodeMulticlassClassification("paper", N_CLASSES, dim)
        self.head = self.task.head()

    def forward(self, graph):
        g = graph.replace_features(node_sets={
            "paper": {HIDDEN_STATE: torch.relu(
                self.init(graph.node_sets["paper"]["feat"]))}})
        return self.task.predict(self.head, self.gnn(g))


@dataclasses.dataclass
class ServeRun:
    """What the example prints, on the host."""
    device: str
    ladder: tuple
    warmup_s: float
    logits: np.ndarray           # serve_sync([1, 2, 3]): [3, N_CLASSES]
    closed: LoadReport
    open: LoadReport
    versions: tuple              # store version before and after add_edges
    stats: ServeSnapshot         # after the freshness step
    recompiles: int


def run(device=None, *, papers: int = PAPERS, clients: int = CLIENTS,
        requests_per_client: int = REQUESTS_PER_CLIENT,
        open_loop_s: float = OPEN_LOOP_S, max_batch: int = MAX_BATCH,
        params=None, seed: int = 0) -> ServeRun:
    """The example on `device` (CUDA by default; raises without a card).
    Parameters: `params`, a tree in the example's layout (``{"init",
    "gnn", "head"}`` of numpy leaves of ``split_params(...)[0]``), or
    else ``init_params(model, seed)``.  Raises RuntimeError if the
    freshness step does not bump the version or evict stale entries."""
    device = resolve_device(device)
    store, spec = problem(papers)
    model = ServeModel()
    if params is not None:
        load_jax_params(model, params)
    else:
        init_params(model, seed)
    model = model.to(device).eval()

    t0 = time.perf_counter()
    server = GNNServer(store, spec, model, device=device,
                       max_batch=max_batch, batch_window_ms=1.0)
    warmup_s = time.perf_counter() - t0
    try:
        logits = server.serve_sync([1, 2, 3], timeout=30)
        roots = range(min(papers, 400))
        closed = closed_loop(server, roots, clients=clients,
                             requests_per_client=requests_per_client,
                             seed=0)
        opened = open_loop(server, roots, qps=max(closed.qps * 0.5, 20.0),
                           duration_s=open_loop_s, seed=1)

        # -- freshness: mutate the graph, caches invalidate -------------
        before = server.submit(5).result(30)
        if not np.allclose(before, server.submit(5).result(30)):
            raise RuntimeError("a repeated query changed its answer")
        v0 = store.version
        store.add_edges("cites", [5], [int(papers - 1)])
        if store.version != v0 + 1:
            raise RuntimeError("mutation must bump the version")
        server.submit(5).result(30)  # resamples: stale entries evicted
        stats = server.stats
        if stats.invalidations <= 0:
            raise RuntimeError("stale entries were not evicted")
        recompiles = server.steady_state_recompiles
    finally:
        server.close()
    return ServeRun(device=str(device), ladder=tuple(server.ladder.rungs),
                    warmup_s=warmup_s, logits=logits, closed=closed,
                    open=opened, versions=(v0, store.version), stats=stats,
                    recompiles=recompiles)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--papers", type=int, default=PAPERS)
    ap.add_argument("--clients", type=int, default=CLIENTS)
    ap.add_argument("--requests-per-client", type=int,
                    default=REQUESTS_PER_CLIENT)
    ap.add_argument("--open-loop-s", type=float, default=OPEN_LOOP_S)
    ap.add_argument("--max-batch", type=int, default=MAX_BATCH)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})")
    schema = mag_schema()
    bounds = spec_size_bounds(sampling_spec(schema), schema)
    print(f"per-request worst case: {bounds.total_num_nodes} nodes, "
          f"{bounds.total_num_edges} edges")
    try:
        res = run(device, papers=args.papers, clients=args.clients,
                  requests_per_client=args.requests_per_client,
                  open_loop_s=args.open_loop_s, max_batch=args.max_batch)
    except RuntimeError as exc:
        raise SystemExit(f"gnn_serve: {exc}") from exc
    graphs = "one CUDA graph per rung" if device.type == "cuda" else "eager"
    print(f"warmup: {res.warmup_s:.2f}s, bucket ladder {list(res.ladder)} "
          f"({graphs})")
    print(f"serve_sync([1, 2, 3]) -> logits {res.logits.shape}, "
          f"argmax {np.argmax(res.logits, axis=-1).tolist()}")
    print(f"closed loop: {res.closed.summary()}")
    print(f"open loop:   {res.open.summary()}")
    stats = res.stats
    print(f"freshness: version {res.versions[0]} -> {res.versions[1]}, "
          f"{stats.invalidations} stale entries evicted")
    print(f"stats: {stats.served} served in {stats.batches} batches "
          f"{dict(sorted(stats.batch_sizes.items()))}, "
          f"embedding hits/misses "
          f"{stats.embedding_hits}/{stats.embedding_misses}, "
          f"steady-state recompiles {res.recompiles}")
    if res.closed.errors or res.open.errors:
        raise SystemExit(f"load generation saw errors: "
                         f"closed={res.closed.errors} "
                         f"open={res.open.errors}")
    if res.recompiles != 0:
        raise SystemExit(f"serving invariant violated: {res.recompiles} "
                         "steady-state recompile(s) — a live request "
                         "missed the warmed bucket ladder")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
