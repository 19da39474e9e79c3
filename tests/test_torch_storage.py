"""The port's out-of-core storage (`repro_torch.storage`) against the
reference's, on the CPU.

* `write_graph` directories are byte-identical across the packages (every
  `.npy`, `schema.json` and `meta.json`), for a synthetic MAG store and a
  heterogeneous store with an empty edge set and a zero-degree node, and
  each package's `MmapGraphStore` reads the other's directory.
* Sampling through `MmapGraphStore` (``gather_chunk_rows`` None, 1 and 8)
  and through a 2-shard `ShardedGraphStore` (remote lookups, the LRU, the
  local fallback after its peer dies) equals the in-memory store, exactly.
* The dial-in fleet (forked `dial_worker_main` processes that know only
  the service's address and the directory) streams exactly the thread
  fleet's batches, at 1 and 2 shards and across a shard worker killed
  mid-epoch; the shard count is validated.
* The `convert` CLI writes the reference CLI's bytes and describes them.
* The twin of examples/out_of_core_train.py: `run(device="cpu")` at 16000
  papers x 1024 features (a 65 MB directory, so its peak-RSS check
  means something) gives exactly equal losses for the dial and thread
  fleets; at a small size its model, labels and fleet match the
  reference's ``runner.run(sampler="service", num_devices=None)`` from
  the same parameters at rtol 1e-4 / atol 1e-5 per step.
"""
import multiprocessing as mp
import os
import types

import jax
import numpy as np
import pytest

from repro.core import HIDDEN_STATE as J_HIDDEN
from repro.core.models import vanilla_mpnn as j_vanilla_mpnn
from repro.core.schema import (EdgeSetSpec as JEdgeSetSpec,
                               FeatureSpec as JFeatureSpec,
                               GraphSchema as JGraphSchema,
                               NodeSetSpec as JNodeSetSpec,
                               mag_schema as j_mag_schema)
from repro.data import sampling as j_sampling
from repro.data.synthetic import synthetic_mag as j_synthetic_mag
from repro.nn.layers import Embedding as JEmbedding, Linear as JLinear
from repro.nn.module import Module as JModule
from repro.orchestration import run as j_run
from repro.orchestration.tasks import (
    RootNodeMulticlassClassification as JRootTask)
from repro.orchestration.trainer import Trainer as JTrainer
from repro.sampling_service import SamplingService as JService
from repro.storage import MmapGraphStore as JMmap
from repro.storage import convert as j_convert
from repro.storage import write_graph as j_write_graph

from repro_torch.core.schema import (EdgeSetSpec, FeatureSpec, GraphSchema,
                                     NodeSetSpec, mag_schema)
from repro_torch.data import sampling as t_sampling
from repro_torch.data.batching import find_size_constraints
from repro_torch.data.pipeline import GraphBatcher
from repro_torch.data.serialization import graph_to_flat
from repro_torch.data.synthetic import synthetic_mag as t_synthetic_mag
from repro_torch.orchestration import out_of_core
from repro_torch.sampling_service import SamplingService
from repro_torch.sampling_service import frames
from repro_torch.storage import (FORMAT_NAME, GraphShardServer,
                                 MmapGraphStore, RemoteShardClient,
                                 ShardedGraphStore, ShardMap, convert,
                                 graph_bytes, shard_bounds, write_graph)
from repro_torch.storage.dial_worker import dial_worker_main

STORE_KW = dict(n_papers=240, n_authors=100, n_institutions=8, n_fields=24,
                n_classes=8, feat_dim=16)


def assert_same(a, b):
    """Two graphs (of either package) equal leaf for leaf, exactly."""
    fa, fb = graph_to_flat(a), graph_to_flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def assert_streams(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same(g, w)


def dir_bytes(path):
    """{relative path: bytes} of every file under `path`."""
    out = {}
    for dirpath, _, files in os.walk(path):
        for f in files:
            full = os.path.join(dirpath, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, path)] = fh.read()
    return out


def hetero_store(pkg, empty_edge_set):
    """Two node sets, one populated edge set, one that may be empty, and
    a zero-degree source node, in either package's classes."""
    schema_mod, store_cls = pkg
    schema = schema_mod.GraphSchema(
        node_sets={"a": schema_mod.NodeSetSpec(
            {"x": schema_mod.FeatureSpec("float32", (3,)),
             "y": schema_mod.FeatureSpec("int32")}),
            "b": schema_mod.NodeSetSpec(
                {"z": schema_mod.FeatureSpec("float32", (2,))})},
        edge_sets={"ab": schema_mod.EdgeSetSpec("a", "b"),
                   "ba": schema_mod.EdgeSetSpec("b", "a")})
    rng = np.random.default_rng(7)
    edges = {"ab": (rng.integers(0, 6, 20), rng.integers(0, 5, 20)),
             "ba": (np.zeros(0, np.int64), np.zeros(0, np.int64))}
    if not empty_edge_set:
        edges["ba"] = (rng.integers(0, 5, 9), rng.integers(0, 7, 9))
    feats = {"a": {"x": rng.normal(size=(7, 3)).astype(np.float32),
                   "y": rng.integers(0, 9, 7).astype(np.int32)},
             "b": {"z": rng.normal(size=(5, 2)).astype(np.float32)}}
    return store_cls(schema, edges, feats, {"a": 7, "b": 5})


J_PKG = (types.SimpleNamespace(GraphSchema=JGraphSchema,
                               NodeSetSpec=JNodeSetSpec,
                               EdgeSetSpec=JEdgeSetSpec,
                               FeatureSpec=JFeatureSpec),
         j_sampling.GraphStore)
T_PKG = (types.SimpleNamespace(GraphSchema=GraphSchema,
                               NodeSetSpec=NodeSetSpec,
                               EdgeSetSpec=EdgeSetSpec,
                               FeatureSpec=FeatureSpec),
         t_sampling.GraphStore)


def spec_of(sampling, schema):
    b = sampling.SamplingSpecBuilder(schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(6, "cites")
    cited.join([seed_op]).sample(4, "written")
    return seed_op.build()


@pytest.fixture(scope="module")
def p(tmp_path_factory):
    jstore, _ = j_synthetic_mag(**STORE_KW)
    tstore, _ = t_synthetic_mag(**STORE_KW)
    tspec = spec_of(t_sampling, mag_schema())
    roots = list(range(64))
    graphs = t_sampling.InMemorySampler(tstore, tspec, seed=0).sample(roots)
    base = tmp_path_factory.mktemp("gd")
    return types.SimpleNamespace(
        jstore=jstore, tstore=tstore, tspec=tspec,
        jspec=spec_of(j_sampling, j_mag_schema()), roots=roots,
        graphs=graphs, sizes=find_size_constraints(graphs, 8),
        tdir=write_graph(tstore, str(base / "port")),
        jdir=j_write_graph(jstore, str(base / "reference")))


# ---------------------------------------------------------------------------
# the GraphDirectory format
# ---------------------------------------------------------------------------

def test_synthetic_directories_are_byte_identical(p):
    got, want = dir_bytes(p.tdir), dir_bytes(p.jdir)
    assert sorted(got) == sorted(want)
    assert "meta.json" in got and "schema.json" in got
    for name in want:
        assert got[name] == want[name], name
    assert graph_bytes(p.tdir) == graph_bytes(p.jdir) == sum(
        len(v) for k, v in got.items() if k.endswith(".npy"))


@pytest.mark.parametrize("empty_edge_set", [True, False])
def test_hetero_directories_are_byte_identical(tmp_path, empty_edge_set):
    got = write_graph(hetero_store(T_PKG, empty_edge_set),
                      str(tmp_path / "t"))
    want = j_write_graph(hetero_store(J_PKG, empty_edge_set),
                         str(tmp_path / "j"))
    assert dir_bytes(got) == dir_bytes(want)
    store = MmapGraphStore(got)
    assert store.edges_sorted_by_target == JMmap(want).edges_sorted_by_target
    assert store.edges_sorted_by_target["ba"] or not empty_edge_set
    assert len(store.neighbors("ab", 6)) == 0  # zero-degree source


def test_each_package_reads_the_others_directory(p):
    spec = p.tspec
    for store in (MmapGraphStore(p.jdir), MmapGraphStore(p.tdir)):
        assert store.num_nodes == p.tstore.num_nodes
        for name in p.tstore.edges:
            for u in (0, 5, 99):
                np.testing.assert_array_equal(
                    store.neighbors(name, u), p.tstore.neighbors(name, u))
        for root in (0, 17, 63):
            assert_same(
                t_sampling.sample_subgraph(store, spec, root,
                                           t_sampling.seed_rng(0, root)),
                t_sampling.sample_subgraph(p.tstore, spec, root,
                                           t_sampling.seed_rng(0, root)))
    jstore = JMmap(p.tdir)
    for root in (3, 40):
        assert_same(
            j_sampling.sample_subgraph(jstore, p.jspec, root,
                                       j_sampling.seed_rng(0, root)),
            t_sampling.sample_subgraph(p.tstore, spec, root,
                                       t_sampling.seed_rng(0, root)))


def test_mmap_store_refuses_what_is_not_a_graph(tmp_path, p):
    with pytest.raises(FileNotFoundError, match="meta.json"):
        MmapGraphStore(str(tmp_path))
    with pytest.raises(ValueError, match="gather_chunk_rows"):
        MmapGraphStore(p.tdir, gather_chunk_rows=0)
    assert FORMAT_NAME == "graphdir-v1"


@pytest.mark.parametrize("chunk", [None, 1, 8])
def test_mmap_sampling_equals_in_memory(p, chunk):
    store = MmapGraphStore(p.tdir, gather_chunk_rows=chunk)
    got = t_sampling.InMemorySampler(store, p.tspec, seed=0).sample(
        p.roots[:24])
    for g, w in zip(got, p.graphs[:24]):
        assert_same(g, w)
    ids = np.asarray([5, 3, 5, 200, 0], np.int64)
    rows = store.gather_node_features("paper", ids)
    for k, v in p.tstore.node_features["paper"].items():
        np.testing.assert_array_equal(rows[k], np.asarray(v)[ids])
    store.drop_page_cache()  # views stay valid after the drop
    assert_same(t_sampling.sample_subgraph(store, p.tspec, 9,
                                           t_sampling.seed_rng(0, 9)),
                p.graphs[9])


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_bounded_gather_reads_what_indexing_gives(tmp_path, chunk):
    """The bounded path's positional reads against numpy indexing of the
    mapping: runs of consecutive rows, duplicates, negative ids, empty
    ids, 1-D and 3-D arrays, a zero-width row; out of range raises."""
    from repro_torch.storage.format import _read_rows
    rng = np.random.default_rng(3)
    for shape in ((50,), (50, 7), (50, 2, 3), (50, 0)):
        path = str(tmp_path / f"a{len(shape)}{shape[-1]}.npy")
        np.save(path, rng.normal(size=shape).astype(np.float32))
        arr = np.load(path, mmap_mode="r")
        for ids in ([4, 5, 6, 7, 30, 5, 49, 0, 1], [], [-1, -50, 3],
                    rng.integers(0, 50, 40), np.arange(50)):
            ids = np.asarray(ids, np.int64)
            want = np.asarray(arr[ids])
            got = _read_rows(arr, ids, chunk)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        for bad in ([50], [-51]):
            with pytest.raises(IndexError):
                _read_rows(arr, np.asarray(bad, np.int64), chunk)


def test_two_shard_store_equals_in_memory_with_lru_and_fallback(p):
    np.testing.assert_array_equal(shard_bounds(10, 4), [0, 2, 5, 7, 10])
    sm = ShardMap({"n": 10}, 4)
    np.testing.assert_array_equal(sm.owner("n", np.arange(10)),
                                  [0, 0, 1, 1, 1, 2, 2, 3, 3, 3])
    assert sm.node_range("n", 1) == (2, 5)
    server = GraphShardServer(MmapGraphStore(p.tdir))
    store = ShardedGraphStore(MmapGraphStore(p.tdir), 0, 2,
                              {1: server.address}, cache_entries=256)
    client = RemoteShardClient(server.address)
    try:
        got = t_sampling.InMemorySampler(store, p.tspec, seed=0).sample(
            p.roots)
        for g, w in zip(got, p.graphs):
            assert_same(g, w)
        assert store.stats["remote"] > 0 and store.stats["local"] > 0
        again = t_sampling.sample_subgraph(store, p.tspec, 50,
                                           t_sampling.seed_rng(0, 50))
        assert store.stats["cache_hits"] > 0
        assert_same(again, p.graphs[50])
        reply = client.request(frames.FEAT, {"node_set": "paper"},
                               {"nodes": np.asarray([3, 239], np.int64)})
        np.testing.assert_array_equal(
            reply["feat"], p.tstore.node_features["paper"]["feat"][[3, 239]])
        server.close()  # the peer dies: lookups fall back to the local map
        store._cache = type(store._cache)(0)
        assert_same(t_sampling.sample_subgraph(store, p.tspec, 61,
                                               t_sampling.seed_rng(0, 61)),
                    p.graphs[61])
        assert store.stats["fallbacks"] > 0
    finally:
        client.close()
        store.close()
        server.close()


# ---------------------------------------------------------------------------
# the dial-in fleet
# ---------------------------------------------------------------------------

def test_config_meta_equals_the_reference_and_round_trips(p):
    """The CONFIG frame's spec, plan and sizes: the same JSON in both
    packages, and each decodes back to what was encoded."""
    import json
    from repro.data.grouping import BatchPlan as JPlan
    from repro.storage import fleet as j_fleet
    from repro_torch.data.grouping import BatchPlan
    from repro_torch.storage import fleet
    for enc, dec, j_enc, tval, jval in (
            (fleet.spec_to_meta, fleet.spec_from_meta, j_fleet.spec_to_meta,
             p.tspec, p.jspec),
            (fleet.plan_to_meta, fleet.plan_from_meta, j_fleet.plan_to_meta,
             BatchPlan(16, seed=3, rank=1, world=2, num_replicas=2,
                       edges_sorted_by_target=False),
             JPlan(16, seed=3, rank=1, world=2, num_replicas=2,
                   edges_sorted_by_target=False)),
            (fleet.sizes_to_meta, fleet.sizes_from_meta,
             j_fleet.sizes_to_meta, p.sizes, p.sizes)):
        meta = json.loads(json.dumps(enc(tval)))
        assert json.dumps(meta, sort_keys=True) == json.dumps(
            j_enc(jval), sort_keys=True)
        assert dec(meta) == tval


def dial_service(p, *, workers, shards):
    """A dial fleet whose workers are forked `dial_worker_main` processes
    pointed at the address the service publishes."""
    if "fork" not in mp.get_all_start_methods():
        pytest.skip("dial-worker tests fork real processes")
    procs = []

    def on_listen(address):
        for _ in range(workers):
            proc = mp.get_context("fork").Process(
                target=dial_worker_main, args=(address, p.tdir),
                daemon=True)
            proc.start()
            procs.append(proc)

    try:
        svc = SamplingService(None, p.tspec, p.roots, batch_size=8,
                              sizes=p.sizes, num_workers=workers, seed=0,
                              backend="dial", num_shards=shards,
                              accept_timeout=30.0, on_listen=on_listen)
    except BaseException:
        reap(procs)
        raise
    return svc, procs


def reap(procs):
    for proc in procs:
        proc.join(10.0)
        if proc.is_alive():
            proc.kill()
            proc.join(5.0)
    assert not any(proc.is_alive() for proc in procs)


@pytest.mark.parametrize("workers,shards", [(1, 1), (2, 2)])
def test_dial_stream_equals_thread_fleet(p, workers, shards):
    with SamplingService(p.tstore, p.tspec, p.roots, batch_size=8,
                         sizes=p.sizes, num_workers=2, seed=0,
                         backend="thread") as ref:
        want = [list(ref.epoch(e)) for e in (0, 1)]
    assert_streams(want[0], list(GraphBatcher(p.graphs, 8, p.sizes,
                                              seed=0).epoch(0)))
    svc, procs = dial_service(p, workers=workers, shards=shards)
    try:
        assert svc.address is not None
        for e in (0, 1):
            assert_streams(list(svc.epoch(e)), want[e])
    finally:
        svc.close()
        reap(procs)
    assert all(proc.exitcode == 0 for proc in procs)


def test_dial_shard_worker_killed_mid_epoch(p):
    want = list(GraphBatcher(p.graphs, 8, p.sizes, seed=0).epoch(0))
    svc, procs = dial_service(p, workers=2, shards=2)
    try:
        got = []
        for i, g in enumerate(svc.epoch(0)):
            got.append(g)
            if i == 1:
                procs[0].kill()  # shard 0's worker and shard server die
        assert_streams(got, want)
    finally:
        svc.close()
        reap(procs)


def test_dial_validates_its_arguments(p):
    with pytest.raises(ValueError, match="num_shards"):
        SamplingService(None, p.tspec, p.roots, batch_size=8, sizes=p.sizes,
                        num_workers=2, backend="dial", num_shards=3,
                        accept_timeout=5.0)
    with pytest.raises(ValueError, match="store=None"):
        SamplingService(p.tstore, p.tspec, p.roots, batch_size=8,
                        sizes=p.sizes, backend="dial")
    with pytest.raises(ValueError, match="cannot respawn"):
        SamplingService(None, p.tspec, p.roots, batch_size=8, sizes=p.sizes,
                        backend="dial", respawn=True)
    with pytest.raises(ValueError, match="requires a store"):
        SamplingService(None, p.tspec, p.roots, batch_size=8, sizes=p.sizes,
                        backend="process")
    with pytest.raises(TimeoutError, match="dialed in"):
        SamplingService(None, p.tspec, p.roots, batch_size=8, sizes=p.sizes,
                        num_workers=1, backend="dial", accept_timeout=0.3)


# ---------------------------------------------------------------------------
# the convert CLI
# ---------------------------------------------------------------------------

def test_convert_cli_writes_the_reference_bytes(tmp_path, capsys):
    args = ["--synthetic-mag", "--papers", "120", "--feat-dim", "8"]
    assert convert.main(["--out", str(tmp_path / "t")] + args) == 0
    assert j_convert.main(["--out", str(tmp_path / "j")] + args) == 0
    assert dir_bytes(tmp_path / "t") == dir_bytes(tmp_path / "j")
    capsys.readouterr()
    assert convert.main(["--info", str(tmp_path / "t")]) == 0
    info = capsys.readouterr().out
    assert j_convert._info(str(tmp_path / "j")).replace(
        str(tmp_path / "j"), str(tmp_path / "t")) == info.strip()
    assert "node set paper: 120 nodes" in info
    with pytest.raises(SystemExit):
        convert.main(["--out", str(tmp_path / "x")])


# ---------------------------------------------------------------------------
# the out-of-core twin
# ---------------------------------------------------------------------------

def test_out_of_core_twin_dial_equals_thread_below_graph_bytes():
    data = out_of_core.problem(16_000, 1024, 16)
    result = out_of_core.run(device="cpu", steps=2, roots=16, data=data)
    assert result.dial.step == result.thread.step == 2
    assert result.dial.metrics["train_losses"] == \
        result.thread.metrics["train_losses"]
    assert all(np.isfinite(result.thread.metrics["train_losses"]))
    assert result.graph_bytes > 64 * 2 ** 20
    assert len(result.peak_rss) == 2
    assert all(0 < peak < result.graph_bytes for peak in result.peak_rss)


class JInitStates(JModule):
    """The example's init states (examples/out_of_core_train.py)."""

    def __init__(self, feat_dim, dim):
        self.paper = JLinear(feat_dim, dim)
        self.tables = {"author": JEmbedding(4096, dim)}

    def init(self, key):
        ks = jax.random.split(key, 2)
        return {"paper": self.paper.init(ks[0]),
                "author": self.tables["author"].init(ks[1])}

    def __call__(self, params, graph):
        ns = {"paper": {J_HIDDEN: jax.nn.relu(self.paper(
            params["paper"], graph.node_sets["paper"]["feat"]))}}
        ids = graph.node_sets["author"]["id"] % 4096
        ns["author"] = {J_HIDDEN: self.tables["author"](
            params["author"], ids, dtype=jax.numpy.float32)}
        return graph.replace_features(node_sets=ns)


def test_out_of_core_twin_matches_the_reference_runner():
    """The twin's model, labels and thread fleet against the reference's
    runner with the same fleet and plan, scalar batches, no mesh."""
    feat, dim, steps = 16, 16, 3
    kw = dict(n_papers=300, n_authors=75, n_institutions=40, n_fields=80,
              n_classes=8, feat_dim=feat)
    jstore, _ = j_synthetic_mag(**kw)
    jspec = spec_of(j_sampling, j_mag_schema())
    data = out_of_core.problem(300, feat, 32)
    store, spec, roots, sizes = data
    jtask = JRootTask("paper", 8, dim)

    def jmodel():
        return JInitStates(feat, dim), j_vanilla_mpnn(
            out_of_core.EDGES, {"paper": dim, "author": dim},
            message_dim=dim, hidden_dim=dim, num_rounds=2)

    initial = jax.tree_util.tree_map(np.asarray, JTrainer(
        seed=0)._init_params(*jmodel(), jtask.head()))
    want = []
    with JService(jstore, jspec, roots, batch_size=8, sizes=sizes,
                  num_workers=2, seed=0, backend="thread") as jsvc:
        for k in range(1, steps + 1):
            want.append(j_run(
                model_fn=jmodel, task=jtask, epochs=2, learning_rate=3e-3,
                total_steps=100, log_every=10 ** 6, max_steps=k,
                sampler="service", service=jsvc,
                label_fn=jtask.labels).train_loss)
    with out_of_core.fleet(store, spec, roots, sizes, workers=2,
                           backend="thread") as svc:
        got = out_of_core.train_with(svc, "cpu", feat_dim=feat, hidden=dim,
                                     steps=steps, params=initial)
        assert svc.plan.num_replicas is None
    np.testing.assert_allclose(got.metrics["train_losses"], want,
                               rtol=1e-4, atol=1e-5)
