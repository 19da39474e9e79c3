"""The PyTorch port's copies of the reference's host code give identical
arrays: synthetic MAG, Algorithm-1 sampling, merge-and-pad, the serving
size bounds and caches, and the GraphTensor masks.

The port keeps its own copies (it imports nothing of `repro`), so these
tests are what keeps the two from drifting apart.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import make_graph

from repro.data import grouping as j_grouping
from repro.data import sampling as j_sampling
from repro.data.synthetic import synthetic_mag as j_synthetic_mag
from repro.serve import cache as j_cache
from repro.serve import gnn as j_gnn

from repro_torch.core import graph_tensor as t_gt
from repro_torch.data import grouping as t_grouping
from repro_torch.data import sampling as t_sampling
from repro_torch.data.synthetic import synthetic_mag as t_synthetic_mag
from repro_torch.kernels import registry
from repro_torch.serve import cache as t_cache
from repro_torch.serve import gnn as t_gnn

STORE_KW = dict(n_papers=80, n_authors=40, n_institutions=6, n_fields=12,
                n_classes=4, feat_dim=8)


def assert_graphs_identical(a, b):
    """Every leaf equal in value and dtype, every name and capacity."""
    def same(x, y):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)

    same(a.context.sizes, b.context.sizes)
    assert sorted(a.context.features) == sorted(b.context.features)
    assert sorted(a.node_sets) == sorted(b.node_sets)
    for name, ns in a.node_sets.items():
        other = b.node_sets[name]
        assert ns.capacity == other.capacity
        same(ns.sizes, other.sizes)
        assert sorted(ns.features) == sorted(other.features)
        for k in ns.features:
            same(ns.features[k], other.features[k])
    assert sorted(a.edge_sets) == sorted(b.edge_sets)
    for name, es in a.edge_sets.items():
        other = b.edge_sets[name]
        assert es.capacity == other.capacity
        same(es.sizes, other.sizes)
        same(es.adjacency.source, other.adjacency.source)
        same(es.adjacency.target, other.adjacency.target)
        assert (es.adjacency.source_name, es.adjacency.target_name) == \
            (other.adjacency.source_name, other.adjacency.target_name)


def section8_spec(module, schema, fanout=4):
    """The §8 sampling spec (examples/ogbn_mag_train.py), built with either
    package's builder."""
    b = module.SamplingSpecBuilder(schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(2 * fanout, "cites")
    authors = cited.join([seed_op]).sample(fanout, "written")
    author_papers = authors.sample(fanout, "writes")
    authors.sample(fanout, "affiliated_with")
    author_papers.join([seed_op, cited]).sample(fanout, "has_topic")
    return seed_op.build()


@pytest.fixture(scope="module")
def stores():
    return j_synthetic_mag(**STORE_KW), t_synthetic_mag(**STORE_KW)


def test_synthetic_mag_is_identical(stores):
    (js, jl), (ts, tl) = stores
    np.testing.assert_array_equal(jl, tl)
    assert js.num_nodes == ts.num_nodes
    assert js.schema.to_json() == ts.schema.to_json()
    for name in js.edges:
        for x, y in zip(js.edges[name], ts.edges[name]):
            np.testing.assert_array_equal(x, y)
    for ns in js.node_features:
        for k, v in js.node_features[ns].items():
            np.testing.assert_array_equal(v, ts.node_features[ns][k])


@pytest.mark.parametrize("fanout", [2, 4])
def test_sample_subgraph_and_spec_bounds_are_identical(stores, fanout):
    (js, _), (ts, _) = stores
    jspec = section8_spec(j_sampling, js.schema, fanout)
    tspec = section8_spec(t_sampling, ts.schema, fanout)
    assert [op.op_name for op in jspec.sampling_ops] == \
        [op.op_name for op in tspec.sampling_ops]
    for root in (0, 5, 17, 79):
        assert_graphs_identical(
            j_sampling.sample_subgraph(js, jspec, root,
                                       j_sampling.seed_rng(3, root)),
            t_sampling.sample_subgraph(ts, tspec, root,
                                       t_sampling.seed_rng(3, root)))
    jb = j_gnn.spec_size_bounds(jspec, js.schema)
    tb = t_gnn.spec_size_bounds(tspec, ts.schema)
    assert (jb.total_num_components, jb.total_num_nodes,
            jb.total_num_edges) == (tb.total_num_components,
                                    tb.total_num_nodes, tb.total_num_edges)


@pytest.mark.parametrize("sort_by_target", [False, True])
@pytest.mark.parametrize("n_graphs", [1, 3])
def test_merge_and_pad_is_identical(stores, sort_by_target, n_graphs):
    (js, _), (ts, _) = stores
    jspec = section8_spec(j_sampling, js.schema)
    tspec = section8_spec(t_sampling, ts.schema)
    roots = [2, 9, 33][:n_graphs]
    jg = [j_sampling.sample_subgraph(js, jspec, r, j_sampling.seed_rng(0, r))
          for r in roots]
    tg = [t_sampling.sample_subgraph(ts, tspec, r, t_sampling.seed_rng(0, r))
          for r in roots]
    sizes = j_gnn.build_ladder(j_gnn.spec_size_bounds(jspec, js.schema),
                               4, 8).sizes[4]
    assert_graphs_identical(
        j_grouping.merge_and_pad(jg, sizes, sort_by_target=sort_by_target),
        t_grouping.merge_and_pad(tg, sizes, sort_by_target=sort_by_target))


def test_ladder_keeps_rung_8_where_the_tpu_budget_stops():
    """The §8 spec at max_batch=8: rung 8 holds 612 x 8 = 4896
    field_of_study targets.  The reference's VMEM cap (4096 segments)
    drops it; the GPU kernels have no segment cap, so the port keeps it."""
    from repro.core.schema import mag_schema as j_mag_schema
    from repro_torch.core.schema import mag_schema as t_mag_schema
    jspec = section8_spec(j_sampling, j_mag_schema())
    tspec = section8_spec(t_sampling, t_mag_schema())
    jl = j_gnn.build_ladder(j_gnn.spec_size_bounds(jspec, j_mag_schema()),
                            8, 128)
    tl = t_gnn.build_ladder(t_gnn.spec_size_bounds(tspec, t_mag_schema()),
                            8)
    assert jl.rungs == (1, 2, 4) and jl.budget_limited
    assert tl.rungs == (1, 2, 4, 8)
    assert tl.sizes[8].total_num_nodes["field_of_study"] == 4896
    for rung in jl.rungs:
        assert dataclasses.astuple(jl.sizes[rung]) == \
            dataclasses.astuple(tl.sizes[rung])
    # the rungs are powers of two up to max_batch, and max_batch itself
    assert t_gnn.build_ladder(t_gnn.spec_size_bounds(
        tspec, t_mag_schema()), 6).rungs == (1, 2, 4, 6)


def test_subgraph_cache_and_versioned_store_behave_identically(stores):
    (js, _), (ts, _) = stores
    jstore = j_cache.VersionedGraphStore.wrap(js)
    tstore = t_cache.VersionedGraphStore.wrap(ts)
    jspec = section8_spec(j_sampling, js.schema)
    tspec = section8_spec(t_sampling, ts.schema)
    jc = j_cache.SubgraphCache(jstore, jspec, capacity=2, base_seed=1)
    tc = t_cache.SubgraphCache(tstore, tspec, capacity=2, base_seed=1)
    for root in (1, 2, 1, 3, 1):
        assert_graphs_identical(jc.get(root), tc.get(root))
    assert dataclasses.astuple(jc.stats) == dataclasses.astuple(tc.stats)
    assert jstore.add_edges("cites", [1], [70]) == \
        tstore.add_edges("cites", [1], [70]) == 1
    assert_graphs_identical(jc.get(1), tc.get(1))
    assert dataclasses.astuple(jc.stats) == dataclasses.astuple(tc.stats)


@pytest.mark.parametrize("pad", [False, True])
def test_mask_and_component_ids_match(pad):
    """Host (numpy) and device (torch) forms of the port's mask() and
    component_ids() against the reference's, with and without padding."""
    import jax
    import jax.numpy as jnp
    kw = dict(pad_users=3, pad_items=2, pad_edges=4) if pad else {}
    ref = jax.tree_util.tree_map(jnp.asarray, make_graph(**kw))
    host = make_graph(**kw)
    port = t_gt.GraphTensor(
        t_gt.Context(host.context.sizes, {}),
        {n: t_gt.NodeSet(ns.sizes, {}, ns.capacity)
         for n, ns in host.node_sets.items()},
        {n: t_gt.EdgeSet(es.sizes, t_gt.Adjacency(
            es.adjacency.source, es.adjacency.target,
            es.adjacency.source_name, es.adjacency.target_name), {},
            es.capacity) for n, es in host.edge_sets.items()})
    dev = t_gt.to_device(port, "cpu")
    for sets in ("node_sets", "edge_sets"):
        for name, piece in getattr(ref, sets).items():
            for form in (port, dev):
                p = getattr(form, sets)[name]
                np.testing.assert_array_equal(np.asarray(p.mask()),
                                              np.asarray(piece.mask()))
                np.testing.assert_array_equal(
                    np.asarray(p.component_ids()),
                    np.asarray(piece.component_ids()))


def test_to_device_index_types():
    """Ids reach the model as int64 (torch's index type) and the kernels
    as contiguous int32; float features keep their dtype."""
    dev = t_gt.to_device(t_gt.GraphTensor(
        t_gt.Context(np.asarray([1], np.int32), {}),
        {"n": t_gt.NodeSet(np.asarray([3], np.int32),
                           {"f": np.ones((3, 2), np.float32),
                            "id": np.arange(3, dtype=np.int32)}, 3)},
        {"e": t_gt.EdgeSet(np.asarray([2], np.int32), t_gt.Adjacency(
            np.asarray([0, 2], np.int32), np.asarray([1, 1], np.int32),
            "n", "n"), {}, 2)}), "cpu")
    adj = dev.edge_sets["e"].adjacency
    assert adj.source.dtype == adj.target.dtype == torch.int64
    assert dev.node_sets["n"]["id"].dtype == torch.int64
    assert dev.node_sets["n"]["f"].dtype == torch.float32
    ids = registry.kernel_ids(adj.target.flip(0))
    assert ids.dtype == torch.int32 and ids.is_contiguous()
    assert ids.tolist() == [1, 1]


# ---------------------------------------------------------------------------
# training-slice host copies: size profiling, batch planning, the batcher
# and the store-backed provider
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sampled(stores):
    """48 rooted subgraphs of the §8 spec, sampled by each package."""
    (js, _), (ts, _) = stores
    jspec = section8_spec(j_sampling, js.schema, 2)
    tspec = section8_spec(t_sampling, ts.schema, 2)
    jg = [j_sampling.sample_subgraph(js, jspec, r, j_sampling.seed_rng(0, r))
          for r in range(48)]
    tg = [t_sampling.sample_subgraph(ts, tspec, r, t_sampling.seed_rng(0, r))
          for r in range(48)]
    return jg, tg


@pytest.mark.parametrize("batch_size,slack", [(4, 1.1), (16, 1.5)])
def test_find_size_constraints_is_identical(sampled, batch_size, slack):
    from repro.data.batching import find_size_constraints as j_find
    from repro_torch.data.batching import find_size_constraints as t_find
    jg, tg = sampled
    assert dataclasses.astuple(j_find(jg, batch_size, slack=slack)) == \
        dataclasses.astuple(t_find(tg, batch_size, slack=slack))


@pytest.mark.parametrize("kw", [dict(batch_size=8),
                                dict(batch_size=8, seed=3, rank=1, world=2),
                                dict(batch_size=12, num_replicas=3)])
def test_batch_plan_is_identical(kw):
    jp, tp = j_grouping.BatchPlan(**kw), t_grouping.BatchPlan(**kw)
    assert (jp.per_rank, jp.per_group) == (tp.per_rank, tp.per_group)
    for epoch in (0, 1, 5):
        jo, to = jp.order(epoch, 50), tp.order(epoch, 50)
        np.testing.assert_array_equal(jo, to)
        assert jp.num_steps(50) == tp.num_steps(50)
        for step in range(jp.num_steps(50)):
            np.testing.assert_array_equal(jp.step_indices(jo, step),
                                          tp.step_indices(to, step))
    np.testing.assert_array_equal(
        j_grouping.epoch_rng(4, 2).integers(0, 1000, 8),
        t_grouping.epoch_rng(4, 2).integers(0, 1000, 8))
    for bad in (dict(batch_size=7, world=2), dict(batch_size=8,
                                                  num_replicas=3)):
        with pytest.raises(ValueError):
            t_grouping.BatchPlan(**bad)


@pytest.mark.parametrize("world", [1, 2])
def test_step_size_constraints_are_identical(sampled, world):
    from repro.data.batching import find_size_constraints as j_find
    jg, _ = sampled
    sizes = j_find(jg, 8)
    for kw in (dict(batch_size=8, world=world),
               dict(batch_size=8, world=world, num_replicas=2)):
        assert dataclasses.astuple(j_grouping.step_size_constraints(
            j_grouping.BatchPlan(**kw), sizes)) == \
            dataclasses.astuple(t_grouping.step_size_constraints(
                t_grouping.BatchPlan(**kw), sizes))


@pytest.mark.parametrize("num_replicas", [None, 2])
@pytest.mark.parametrize("sort", [True, False])
def test_build_batch_and_stacking_are_identical(sampled, num_replicas,
                                                sort):
    from repro.core.graph_tensor import stack_size as j_stack_size
    from repro.core.graph_tensor import unstack_graph as j_unstack
    from repro.data.batching import find_size_constraints as j_find
    jg, tg = sampled
    kw = dict(batch_size=8, num_replicas=num_replicas,
              edges_sorted_by_target=sort)
    sizes = j_find(jg, 8 // (num_replicas or 1))
    jb = j_grouping.build_batch(jg[:8], j_grouping.BatchPlan(**kw), sizes)
    tb = t_grouping.build_batch(tg[:8], t_grouping.BatchPlan(**kw), sizes)
    assert_graphs_identical(jb, tb)
    assert j_stack_size(jb) == t_gt.stack_size(tb) == num_replicas
    if num_replicas:
        for a, b in zip(j_unstack(jb), t_gt.unstack_graph(tb)):
            assert_graphs_identical(a, b)
        assert_graphs_identical(
            t_gt.stack_graphs(t_gt.unstack_graph(tb)), tb)
    with pytest.raises(ValueError, match="expected 8 graphs"):
        t_grouping.build_batch(tg[:7], t_grouping.BatchPlan(**kw), sizes)


def test_stack_graphs_rejects_mismatched_structures(sampled):
    from repro.data.batching import find_size_constraints as j_find
    _, tg = sampled
    a = t_grouping.merge_and_pad(tg[:2], j_find(tg, 2))
    b = t_grouping.merge_and_pad(tg[:2], j_find(tg, 3))
    with pytest.raises(ValueError, match="not structurally identical"):
        t_gt.stack_graphs([a, b])
    with pytest.raises(ValueError, match="empty"):
        t_gt.stack_graphs([])


@pytest.mark.parametrize("kw", [dict(), dict(seed=5, rank=1, world=2),
                                dict(num_replicas=2,
                                     edges_sorted_by_target=False)])
def test_graph_batcher_and_providers_are_identical(stores, sampled, kw):
    """GraphBatcher epochs (with a restart's start_step), and the
    StoreProvider's sample-on-demand stream, array for array."""
    from repro.data.batching import find_size_constraints as j_find
    from repro.data.pipeline import GraphBatcher as JBatcher
    from repro.orchestration.providers import StoreProvider as JStore
    from repro_torch.data.pipeline import GraphBatcher as TBatcher
    from repro_torch.orchestration.providers import StoreProvider as TStore
    (js, _), (ts, _) = stores
    jg, tg = sampled
    sizes = j_find(jg, 8 // kw.get("num_replicas", 1))
    jb, tb = JBatcher(jg, 8, sizes, **kw), TBatcher(tg, 8, sizes, **kw)
    assert jb.num_steps == tb.num_steps == 6
    for epoch, start in ((0, 0), (1, 4)):
        got = list(tb.epoch(epoch, start_step=start))
        want = list(jb.epoch(epoch, start_step=start))
        assert len(got) == len(want) == 6 - start
        for a, b in zip(want, got):
            assert_graphs_identical(a, b)
    roots = list(range(48))
    jp = JStore(js, section8_spec(j_sampling, js.schema, 2), roots,
                batch_size=8, sizes=sizes, **kw)
    tp = TStore(ts, section8_spec(t_sampling, ts.schema, 2), roots,
                batch_size=8, sizes=sizes, **kw)
    assert jp.num_steps == tp.num_steps
    assert tp.edges_sorted_by_target == kw.get("edges_sorted_by_target",
                                               True)
    for a, b in zip(jp.epoch(2, start_step=3), tp.epoch(2, start_step=3)):
        assert_graphs_identical(a, b)
    # the store stream is the batcher's stream over the same roots
    for a, b in zip(tp.epoch(0), tb.epoch(0)):
        assert_graphs_identical(a, b)


def test_prefetch_reraises_and_joins_on_early_close():
    """The copy keeps the reference's contract: a source error reaches the
    consumer after the buffered items, and closing early joins the
    worker thread instead of leaking it on a full queue."""
    import threading
    from repro_torch.data.pipeline import prefetch

    def failing():
        yield 1
        yield 2
        raise KeyError("boom")

    got = []
    with pytest.raises(KeyError, match="boom"):
        for x in prefetch(failing(), depth=1):
            got.append(x)
    assert got == [1, 2]
    before = threading.active_count()
    it = prefetch(iter(range(10 ** 6)), depth=2)
    assert next(it) == 0
    it.close()
    assert threading.active_count() == before
    assert not any(t.name == "graph-prefetch" and t.is_alive()
                   for t in threading.enumerate())


@pytest.mark.parametrize("kw", [
    dict(num_graphs=24, num_classes=3, feat_dim=16, seed=0),
    dict(num_graphs=10, num_classes=2, min_nodes=4, max_nodes=6,
         feat_dim=5, noise=0.5, seed=3)])
def test_synthetic_graph_classification_is_identical(kw):
    from repro.data.synthetic import synthetic_graph_classification as j_gc
    from repro_torch.data.synthetic import synthetic_graph_classification
    want = j_gc(**kw)
    got = synthetic_graph_classification(**kw)
    assert len(got) == len(want) == kw["num_graphs"]
    for a, b in zip(got, want):
        assert_graphs_identical(a, b)
        np.testing.assert_array_equal(a.context["label"],
                                      b.context["label"])
        assert a.context["label"].dtype == b.context["label"].dtype


@pytest.mark.parametrize("kw", [
    dict(batch=2, seq=32, vocab=256, steps=8, seed=1),
    dict(batch=3, seq=17, vocab=151936, steps=2, seed=0)])
def test_token_batches_are_identical(kw):
    """The LM stream the train twin and the card's [lm-train] read."""
    from repro.data.synthetic import token_batches as j_tokens
    from repro_torch.data.synthetic import token_batches
    want = list(j_tokens(**kw))
    got = list(token_batches(**kw))
    assert len(got) == len(want) == kw["steps"]
    for a, b in zip(got, want):
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype == np.int32
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    for a, b in zip(token_batches(batch=1, seq=4, vocab=9, steps=3,
                                  rng=rng_a),
                    j_tokens(batch=1, seq=4, vocab=9, steps=3, rng=rng_b)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------------
# sampler-fleet host copies: the on-demand and sharded samplers, and the
# flat-dict serialization the frames and sample files carry
# ---------------------------------------------------------------------------

def test_in_memory_sampler_and_shard_partition_are_identical(stores):
    (js, _), (ts, _) = stores
    jspec = section8_spec(j_sampling, js.schema, 2)
    tspec = section8_spec(t_sampling, ts.schema, 2)
    roots = [7, 3, 41, 3]
    for kw in (dict(seed=0), dict(seed=5)):
        for a, b in zip(j_sampling.InMemorySampler(js, jspec, **kw)
                        .sample(roots),
                        t_sampling.InMemorySampler(ts, tspec, **kw)
                        .sample(roots)):
            assert_graphs_identical(a, b)
    # a root's subgraph is a pure function of the root, in any order
    fwd = t_sampling.InMemorySampler(ts, tspec).sample([1, 2])
    rev = t_sampling.InMemorySampler(ts, tspec).sample([2, 1])
    assert_graphs_identical(fwd[0], rev[1])
    factory = t_sampling.InMemorySampler(
        ts, tspec, rng_factory=lambda r: t_sampling.seed_rng(9, r))
    assert_graphs_identical(factory.sample([4])[0],
                            t_sampling.InMemorySampler(ts, tspec, seed=9)
                            .sample([4])[0])
    for n in (1, 3, 4):
        for a, b in zip(j_sampling.shard_partition(range(10), n),
                        t_sampling.shard_partition(range(10), n)):
            np.testing.assert_array_equal(a, b)


def test_distributed_sample_files_load_identically(stores, tmp_path):
    """Each package's shard files hold the same graphs, in file order,
    and each package loads the other's files."""
    from repro.data.serialization import load_graphs as j_load
    from repro_torch.data.serialization import load_graphs as t_load
    (js, _), (ts, _) = stores
    roots = list(range(10))
    jp = j_sampling.distributed_sample(
        js, section8_spec(j_sampling, js.schema, 2), roots,
        str(tmp_path / "j"), num_shards=3, base_seed=2)
    tp = t_sampling.distributed_sample(
        ts, section8_spec(t_sampling, ts.schema, 2), roots,
        str(tmp_path / "t"), num_shards=3, base_seed=2)
    assert [p.rsplit("/", 1)[1] for p in jp] == \
        [p.rsplit("/", 1)[1] for p in tp]
    for jpath, tpath in zip(jp, tp):
        want = j_load(jpath)
        for got in (t_load(tpath), t_load(jpath)):
            assert len(got) == len(want)
            for a, b in zip(want, got):
                assert_graphs_identical(a, b)
        for a, b in zip(j_load(tpath), want):
            assert_graphs_identical(a, b)


@pytest.mark.parametrize("num_replicas", [None, 2])
def test_graph_to_flat_and_back_are_identical(sampled, num_replicas):
    """Scalar and stacked [R, ...] batches flatten to the same keys, in
    the same order, with `#capacity`; each package rebuilds the other's
    flat dict; a file without `#capacity` falls back to the shapes."""
    from repro.data import serialization as j_ser
    from repro.data.batching import find_size_constraints as j_find
    from repro_torch.data import serialization as t_ser
    jg, tg = sampled
    kw = dict(batch_size=8, num_replicas=num_replicas)
    sizes = j_find(jg, 8 // (num_replicas or 1))
    jb = j_grouping.build_batch(jg[:8], j_grouping.BatchPlan(**kw), sizes)
    tb = t_grouping.build_batch(tg[:8], t_grouping.BatchPlan(**kw), sizes)
    jflat, tflat = j_ser.graph_to_flat(jb, "x/"), t_ser.graph_to_flat(tb,
                                                                       "x/")
    assert list(jflat) == list(tflat)
    for k in jflat:
        np.testing.assert_array_equal(jflat[k], tflat[k])
        assert jflat[k].dtype == tflat[k].dtype
    assert_graphs_identical(t_ser.flat_to_graph(tflat, "x/"), tb)
    assert_graphs_identical(t_ser.flat_to_graph(jflat, "x/"), jb)
    assert t_gt.stack_size(t_ser.flat_to_graph(tflat, "x/")) == num_replicas
    if num_replicas is None:
        legacy = {k: v for k, v in tflat.items()
                  if not k.endswith("#capacity")}
        assert_graphs_identical(t_ser.flat_to_graph(legacy, "x/"),
                                j_ser.flat_to_graph(legacy, "x/"))
