"""GraphDirectory converter CLI (a copy of `repro.storage.convert`).

    # materialize a synthetic OGBN-MAG-shaped store as an on-disk graph
    python -m repro_torch.storage.convert --out /data/mag --synthetic-mag \
        --papers 20000 --feat-dim 256

    # describe an existing GraphDirectory
    python -m repro_torch.storage.convert --info /data/mag

The library surface is `repro_torch.storage.write_graph(store, path)` — this
CLI exists so a fleet test/demo can stage a directory without writing
python, and as the template for real dataset importers (read shard,
build `GraphStore`, `write_graph`).
"""
from __future__ import annotations

import argparse
import json
import os


def _info(path: str) -> str:
    from repro_torch.storage.format import MmapGraphStore, graph_bytes
    store = MmapGraphStore(path)
    lines = [f"GraphDirectory {path}",
             f"  payload bytes: {graph_bytes(path):,}"]
    for ns, n in sorted(store.num_nodes.items()):
        feats = ", ".join(
            f"{k}{list(v.shape[1:])}:{v.dtype}"
            for k, v in sorted(store.node_features.get(ns, {}).items()))
        lines.append(f"  node set {ns}: {n:,} nodes  [{feats}]")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    for name, info in sorted(meta["edge_sets"].items()):
        es = store.schema.edge_sets[name]
        lines.append(
            f"  edge set {name}: {es.source}->{es.target}, "
            f"{info['num_edges']:,} edges"
            + (", sorted-by-target" if info["sorted_by_target"] else ""))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write a GraphDirectory here")
    ap.add_argument("--info", metavar="DIR",
                    help="describe an existing GraphDirectory and exit")
    ap.add_argument("--synthetic-mag", action="store_true",
                    help="generate the synthetic OGBN-MAG-shaped store")
    ap.add_argument("--papers", type=int, default=2000)
    ap.add_argument("--feat-dim", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.info:
        print(_info(args.info))
        return 0
    if not args.out:
        ap.error("--out or --info is required")
    if not args.synthetic_mag:
        ap.error("--synthetic-mag is the only source this CLI ships; "
                 "use repro_torch.storage.write_graph(store, path) for "
                 "real data")
    from repro_torch.data.synthetic import synthetic_mag
    from repro_torch.storage.format import write_graph
    store, _ = synthetic_mag(n_papers=args.papers, feat_dim=args.feat_dim,
                             seed=args.seed)
    write_graph(store, args.out)
    print(_info(args.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
