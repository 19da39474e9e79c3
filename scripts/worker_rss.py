#!/usr/bin/env python3
"""What a dial-in sampler worker's peak RSS is made of, on the machine it
runs on.

    PYTHONPATH=src python3 scripts/worker_rss.py [--papers 24000]
        [--feat-dim 1024]

Writes the out-of-core twin's GraphDirectory
(`repro_torch.orchestration.out_of_core.problem`) to a temporary
directory, then runs each probe in a fresh interpreter spawned through
the twin's relay (`out_of_core.RELAY`), so its ``ru_maxrss`` starts at a
bare interpreter:

* numpy's import, with the default BLAS threads and with one;
* 450 random rows of the feature file read through the mapping, through
  the mapping with ``MADV_DONTNEED`` after each row, and with positional
  reads;
* a dial worker's stages, with one BLAS thread as the twin runs it: its
  imports, the store opened with the bounded gather, a shard server, 8
  and then 64 roots sampled, 8 batches encoded as frames.

Each line gives the stage's peak RSS (``ru_maxrss``) and current RSS
(``/proc/self/statm``) in MiB, beside the directory's bytes.
"""
import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

_RSS = r'''
import resource, sys
def rss(tag):
    with open("/proc/self/statm") as f:
        now = int(f.read().split()[1]) * 4096 / 2**20
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print(f"  {tag:34s} peak {peak:7.1f} MiB  now {now:7.1f} MiB",
          flush=True)
'''

ROWS = _RSS + r'''
import mmap, os
mode, path = sys.argv[1], sys.argv[2]
rss("start")
import numpy as np
rss("numpy imported")
if mode != "import":
    rows = np.random.default_rng(0).choice(
        np.load(path, mmap_mode="r").shape[0], 450, replace=False)
    arr = np.load(path, mmap_mode="r")
    if mode == "pread":
        row = arr.itemsize * arr.shape[1]
        off, name = arr.offset, arr.filename
        del arr
        fd = os.open(name, os.O_RDONLY)
        out = np.empty((len(rows), row // 4), np.float32)
        for i, r in enumerate(rows):
            out[i] = np.frombuffer(os.pread(fd, row, off + int(r) * row),
                                   np.float32)
        os.close(fd)
    else:
        arr._mmap.madvise(mmap.MADV_RANDOM)
        out = np.asarray(arr[rows[:1]])
        rss("1 row through the mapping")
        for r in rows:
            out = np.asarray(arr[[r]])
            if mode == "mmap+dontneed":
                arr._mmap.madvise(mmap.MADV_DONTNEED)
    rss(f"450 rows, {mode}")
'''

WORKER = _RSS + r'''
path = sys.argv[1]
rss("start")
import numpy as np
import repro_torch.storage.dial_worker
rss("dial_worker imported")
from repro_torch.core.schema import mag_schema
from repro_torch.data.batching import find_size_constraints
from repro_torch.data.grouping import BatchPlan, build_batch
from repro_torch.data.sampling import InMemorySampler, SamplingSpecBuilder
from repro_torch.sampling_service import frames
from repro_torch.storage import GraphShardServer, MmapGraphStore
store = MmapGraphStore(path, gather_chunk_rows=8)
rss("store opened (gather_chunk_rows 8)")
server = GraphShardServer(store)
rss("shard server started")
b = SamplingSpecBuilder(mag_schema())
seed_op = b.seed("paper")
seed_op.sample(6, "cites").join([seed_op]).sample(4, "written")
spec = seed_op.build()
graphs = InMemorySampler(store, spec).sample(range(8))
rss("8 roots sampled")
graphs = InMemorySampler(store, spec).sample(range(64))
rss("64 roots sampled")
sizes = find_size_constraints(graphs, 8)
for i in range(8):
    blob = frames.encode_frame(frames.BATCH, {}, build_batch(
        graphs[8 * i:8 * i + 8], BatchPlan(8), sizes))
rss(f"8 batches as frames ({len(blob)} B)")
server.close()
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--papers", type=int, default=24_000)
    ap.add_argument("--feat-dim", type=int, default=1024)
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)
    from repro_torch.orchestration import out_of_core
    from repro_torch.storage import graph_bytes, write_graph
    store = out_of_core.problem(args.papers, args.feat_dim, 64)[0]
    one_blas = {k: "1" for k in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS",
                                 "MKL_NUM_THREADS")}
    base = dict(os.environ, PYTHONPATH=SRC)
    print(f"kernel {os.uname().release}, {os.cpu_count()} cpus", flush=True)
    with tempfile.TemporaryDirectory(prefix="worker_rss_") as tmp:
        gdir = write_graph(store, os.path.join(tmp, "graph"))
        feat = os.path.join(gdir, "nodes", "paper.feat.npy")
        print(f"GraphDirectory {graph_bytes(gdir)} bytes "
              f"({graph_bytes(gdir) / 2 ** 20:.1f} MiB), feature file "
              f"{os.path.getsize(feat)} bytes", flush=True)

        def probe(title, code, *probe_args, env=base):
            print(title, flush=True)
            subprocess.run([sys.executable, "-c", out_of_core.RELAY,
                            sys.executable, "-c", code, *probe_args],
                           env=env, check=True, timeout=300)

        probe("numpy, default BLAS threads:", ROWS, "import", feat)
        probe("numpy, one BLAS thread:", ROWS, "import", feat,
              env=dict(base, **one_blas))
        for mode in ("mmap", "mmap+dontneed", "pread"):
            probe(f"feature rows, {mode}, one BLAS thread:", ROWS, mode,
                  feat, env=dict(base, **one_blas))
        probe("dial worker stages, one BLAS thread:", WORKER, gdir,
              env=dict(base, **one_blas))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
