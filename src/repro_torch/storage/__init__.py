"""Out-of-core graph storage: `GraphDirectory` on-disk format, mmap and
sharded `GraphStore`s, and the dial-in sampler fleet (counterpart of
`repro.storage`).

numpy + sockets + stdlib only — this package sits inside the dial-in
worker's import closure (`repro_torch.storage.dial_worker`): nothing
here may import torch.
"""
from repro_torch.storage.format import (FORMAT_NAME, MmapGraphStore,
                                        graph_bytes, write_graph)
from repro_torch.storage.sharded import (GraphShardServer,
                                         RemoteShardClient,
                                         ShardedGraphStore, ShardMap,
                                         shard_bounds)

__all__ = [
    "FORMAT_NAME",
    "GraphShardServer",
    "MmapGraphStore",
    "RemoteShardClient",
    "ShardMap",
    "ShardedGraphStore",
    "graph_bytes",
    "shard_bounds",
    "write_graph",
]
