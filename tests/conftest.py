import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.core.graph_tensor import (Adjacency, Context, EdgeSet,
                                     GraphTensor, NodeSet)


def pytest_configure(config):
    # socket/subprocess tests mark per-test timeouts; the mark is enforced
    # by pytest-timeout when installed (requirements-test.txt) and stays a
    # registered no-op without it — every such test also carries its own
    # structural deadline, so nothing hangs either way.
    config.addinivalue_line(
        "markers",
        "timeout(seconds): per-test timeout (enforced by pytest-timeout "
        "when installed; tests carry structural deadlines regardless)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card and nvcc (the PyTorch port's kernels); "
        "skips elsewhere")


def make_graph(n_users=4, n_items=6, n_purchased=7, n_friend=3, seed=0,
               pad_users=0, pad_items=0, pad_edges=0):
    """The paper's Fig. 2/3 recommender example (+ optional padding)."""
    rng = np.random.default_rng(seed)
    nu, ni = n_users + pad_users, n_items + pad_items
    ne = n_purchased + pad_edges
    src = np.concatenate([rng.integers(0, n_items, n_purchased),
                          np.full(pad_edges, max(n_items - 1, 0))])
    tgt = np.concatenate([rng.integers(0, n_users, n_purchased),
                          np.full(pad_edges, max(n_users - 1, 0))])
    fsrc = rng.integers(0, n_users, n_friend)
    ftgt = rng.integers(0, n_users, n_friend)
    return GraphTensor(
        context=Context(np.asarray([1], np.int32),
                        {"scores": rng.normal(size=(1, 4))
                         .astype(np.float32)}),
        node_sets={
            "users": NodeSet(np.asarray([n_users], np.int32),
                             {"age": rng.integers(18, 60, nu)
                              .astype(np.int32),
                              "h": rng.normal(size=(nu, 8))
                              .astype(np.float32)}, nu),
            "items": NodeSet(np.asarray([n_items], np.int32),
                             {"price": rng.normal(size=(ni, 3))
                              .astype(np.float32),
                              "h": rng.normal(size=(ni, 8))
                              .astype(np.float32)}, ni),
        },
        edge_sets={
            "purchased": EdgeSet(
                np.asarray([n_purchased], np.int32),
                Adjacency(src.astype(np.int32), tgt.astype(np.int32),
                          "items", "users"), {}, ne),
            "is-friend": EdgeSet(
                np.asarray([n_friend], np.int32),
                Adjacency(fsrc.astype(np.int32), ftgt.astype(np.int32),
                          "users", "users"), {}, n_friend),
        })


@pytest.fixture
def graph():
    return jax.tree_util.tree_map(jnp.asarray, make_graph())


@pytest.fixture
def padded_graph():
    return jax.tree_util.tree_map(
        jnp.asarray, make_graph(pad_users=3, pad_items=2, pad_edges=4))
