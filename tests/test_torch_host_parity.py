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
