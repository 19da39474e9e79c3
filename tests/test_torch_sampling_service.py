"""The port's sampler fleet (`repro_torch.sampling_service`) against the
reference's, on the CPU.

* Frames: `encode_frame` gives the same bytes in both packages for the
  same batch (scalar and stacked, either edge layout, and the raw array
  frames of the storage lookups), and each package decodes the other's
  frames (exact: the arrays are copied bytes).
* Streams, array for array (exact), for 1-3 workers, the sort bit True
  and False and ``num_replicas`` None and 2: the port's process and
  thread fleets equal the port's `GraphBatcher` and `StoreProvider` and
  the reference's `SamplingService` for the same plan.
* Worker loss, ``respawn=`` and a worker's ERROR frame, mirroring
  tests/test_sampling_service.py; a bounded `close()` reaps every child.
* `ServiceProvider`'s ``own=`` and ``label_fn=``, and
  ``runner.run(sampler="service", device="cpu")`` from the JAX
  ``Trainer._init_params`` parameters against the JAX runner on the same
  fleet: per-step loss and final parameters at rtol 1e-4 / atol 1e-5
  (fp32 sums in another order, through 3 Adam steps).

Every fleet is closed in a ``with`` block or a ``finally`` (bounded
joins, then SIGKILL), and every socket read carries a timeout.
"""
import multiprocessing as mp
import socket
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import HIDDEN_STATE as J_HIDDEN
from repro.core.models import vanilla_mpnn as j_vanilla_mpnn
from repro.core.schema import mag_schema as j_mag_schema
from repro.data import sampling as j_sampling
from repro.data.grouping import BatchPlan as JPlan, build_batch as j_build
from repro.data.synthetic import synthetic_mag as j_synthetic_mag
from repro.nn.layers import Linear as JLinear
from repro.nn.module import Module as JModule
from repro.orchestration import run as j_run
from repro.orchestration.tasks import (
    RootNodeMulticlassClassification as JRootTask)
from repro.orchestration.trainer import Trainer as JTrainer
from repro.sampling_service import SamplingService as JService
from repro.sampling_service import wire as j_wire

from repro_torch.core.graph_tensor import HIDDEN_STATE
from repro_torch.core.models import vanilla_mpnn
from repro_torch.core.schema import mag_schema as t_mag_schema
from repro_torch.data import sampling as t_sampling
from repro_torch.data.batching import find_size_constraints
from repro_torch.data.grouping import BatchPlan, build_batch
from repro_torch.data.pipeline import GraphBatcher
from repro_torch.data.serialization import graph_to_flat
from repro_torch.data.synthetic import synthetic_mag as t_synthetic_mag
from repro_torch.nn.layers import Linear
from repro_torch.orchestration import runner as t_runner
from repro_torch.orchestration.providers import (ServiceProvider,
                                                 StoreProvider)
from repro_torch.orchestration.tasks import RootNodeMulticlassClassification
from repro_torch.sampling_service import (DeadFleetError, SamplingService,
                                          TcpTransport)
from repro_torch.sampling_service import frames

STORE_KW = dict(n_papers=240, n_authors=100, n_institutions=8, n_fields=24,
                n_classes=8, feat_dim=32)
FORK = "fork" in mp.get_all_start_methods()


def assert_same(a, b):
    """Two batches (of either package) equal leaf for leaf: every array,
    dtype, shape, capacity and endpoint name, via their flat dicts."""
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


def spec_of(sampling, schema):
    b = sampling.SamplingSpecBuilder(schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(8, "cites")
    cited.join([seed_op]).sample(4, "written")
    return seed_op.build()


@pytest.fixture(scope="module")
def p():
    """Both packages' stores, specs and sampled graphs (identical), and
    the size constraints of an 8-graph group."""
    jstore, _ = j_synthetic_mag(**STORE_KW)
    tstore, _ = t_synthetic_mag(**STORE_KW)
    jspec = spec_of(j_sampling, j_mag_schema())
    tspec = spec_of(t_sampling, t_mag_schema())
    roots = list(range(64))
    tg = t_sampling.InMemorySampler(tstore, tspec, seed=0).sample(roots)
    jg = j_sampling.InMemorySampler(jstore, jspec, seed=0).sample(roots)
    return types.SimpleNamespace(
        jstore=jstore, tstore=tstore, jspec=jspec, tspec=tspec,
        roots=roots, tg=tg, jg=jg, sizes=find_size_constraints(tg, 8))


def service(p, **kw):
    kw.setdefault("seed", 0)
    kw.setdefault("num_replicas", 1)
    kw.setdefault("batch_size", 8)
    return SamplingService(p.tstore, p.tspec, p.roots, sizes=p.sizes, **kw)


def needs_fork():
    if not FORK:
        pytest.skip("the process backend forks real processes")


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_replicas", [None, 2])
@pytest.mark.parametrize("sort", [True, False])
def test_frame_bytes_equal_the_reference_and_cross_decode(p, num_replicas,
                                                          sort):
    kw = dict(num_replicas=num_replicas, edges_sorted_by_target=sort)
    tb = build_batch(p.tg[:16], BatchPlan(16, **kw), p.sizes) \
        if num_replicas else build_batch(p.tg[:8], BatchPlan(8, **kw),
                                         p.sizes)
    jb = j_build(p.jg[:16], JPlan(16, **kw), p.sizes) \
        if num_replicas else j_build(p.jg[:8], JPlan(8, **kw), p.sizes)
    meta = {"worker": 1, "epoch": 3, "step": 2}
    tbytes = frames.encode_frame(frames.BATCH, meta, tb)
    assert tbytes == j_wire.encode_frame(j_wire.BATCH, meta, jb)
    for send, recv in ((frames, j_wire), (j_wire, frames)):
        a, b = socket.socketpair()
        try:
            b.settimeout(10.0)
            a.sendall(tbytes)
            send.send_frame(a, send.ASSIGN, {"epoch": 3, "steps": [1, 2]})
            kind, got_meta, graph = recv.recv_frame(b, timeout=10.0)
            assert (kind, got_meta) == ("batch", meta)
            assert_same(graph, tb)
            assert graph.node_sets["paper"].capacity == \
                tb.node_sets["paper"].capacity
            assert recv.recv_frame(b, timeout=10.0) == (
                "assign", {"epoch": 3, "steps": [1, 2]}, None)
        finally:
            a.close()
            b.close()


def test_raw_frames_and_limits_equal_the_reference():
    arrays = {"counts": np.arange(5, dtype=np.int64),
              "neighbors": np.arange(12, dtype=np.int64).reshape(3, 4)[:, 1],
              "feat": np.ones((2, 3), np.float32), "scalar": np.int32(7)}
    assert frames.encode_frame(frames.NBRS, {}, arrays=arrays) == \
        j_wire.encode_frame(j_wire.NBRS, {}, arrays=arrays)
    assert frames.pack_arrays(arrays) == j_wire.pack_arrays(arrays)
    for name in ("MAGIC", "MAX_HEADER_BYTES", "MAX_PAYLOAD_BYTES", "BATCH",
                 "DONE", "ASSIGN", "STOP", "ERROR", "HELLO", "META",
                 "HEARTBEAT", "JOIN", "SHARD", "READY", "CONFIG", "NBR",
                 "NBRS", "FEAT", "FEATS"):
        assert getattr(frames, name) == getattr(j_wire, name), name
    with pytest.raises(ValueError, match="either a graph or raw"):
        frames.encode_frame(frames.BATCH, {}, graph=object(), arrays={})


def test_frame_errors_and_timeout_keep_the_stream():
    a, b = frames.socket_pair()
    try:
        b.settimeout(10.0)
        a.sendall(b"XXXX")
        with pytest.raises(frames.WireError, match="magic"):
            frames.recv_frame(b)
    finally:
        a.close()
        b.close()
    a, b = frames.socket_pair()
    try:
        b.settimeout(10.0)
        a.sendall(frames.MAGIC + b"\x00\x00")  # truncated mid-frame
        a.close()
        with pytest.raises(frames.WireError, match="mid-frame"):
            frames.recv_frame(b)
    finally:
        b.close()
    a, b = TcpTransport().pair()
    try:
        with pytest.raises(socket.timeout):
            frames.recv_frame(b, timeout=0.05)
        frames.send_frame(a, frames.DONE, {"worker": 0})
        assert frames.recv_frame(b, timeout=10.0) == ("done",
                                                      {"worker": 0}, None)
        a.close()
        with pytest.raises(EOFError):
            frames.recv_frame(b, timeout=10.0)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_replicas", [None, 2])
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("workers", [1, 2, 3])
def test_fleet_streams_equal_batcher_store_and_reference(p, workers, sort,
                                                         num_replicas):
    needs_fork()
    batch = 16 if num_replicas else 8
    kw = dict(batch_size=batch, seed=0, num_replicas=num_replicas,
              edges_sorted_by_target=sort)
    want = list(GraphBatcher(p.tg, batch, p.sizes, seed=0,
                             num_replicas=num_replicas,
                             edges_sorted_by_target=sort).epoch(1))
    assert_streams(list(StoreProvider(p.tstore, p.tspec, p.roots,
                                      sizes=p.sizes, **kw).epoch(1)), want)
    with JService(p.jstore, p.jspec, p.roots, sizes=p.sizes,
                  num_workers=workers, backend="thread", **kw) as ref:
        assert_streams(list(ref.epoch(1)), want)
    for backend in ("process", "thread"):
        with service(p, num_workers=workers, backend=backend, **kw) as svc:
            assert svc.num_steps == len(want)
            assert_streams(list(svc.epoch(1)), want)
            assert_streams(list(svc.epoch(1, start_step=2)), want[2:])


def test_tcp_transport_fleet_and_world_sharding(p):
    """The same protocol over loopback TCP, and a rank's 1/world share
    padded to the batcher's rank constraints."""
    sizes16 = find_size_constraints(p.tg, 16)
    for rank in (0, 1):
        want = list(GraphBatcher(p.tg, 16, sizes16, seed=0, rank=rank,
                                 world=2).epoch(0))
        with SamplingService(p.tstore, p.tspec, p.roots, batch_size=16,
                             sizes=sizes16, num_workers=2, seed=0,
                             rank=rank, world=2, backend="thread",
                             transport=TcpTransport()) as svc:
            assert_streams(list(svc.epoch(0)), want)


# ---------------------------------------------------------------------------
# fault tolerance (process workers)
# ---------------------------------------------------------------------------

def reference_epoch(p, epoch):
    return list(GraphBatcher(p.tg, 8, p.sizes, seed=0,
                             num_replicas=1).epoch(epoch))


def test_worker_killed_before_and_mid_epoch_leaves_the_stream(p):
    needs_fork()
    with service(p, num_workers=2) as svc:
        svc.kill_worker(1)
        svc.coordinator.workers[1].process.join(5.0)
        assert_streams(list(svc.epoch(0)), reference_epoch(p, 0))
        assert not svc.coordinator.workers[1].alive
    with service(p, num_workers=2) as svc:
        got = []
        for i, g in enumerate(svc.epoch(0)):
            got.append(g)
            if i == 1:
                svc.kill_worker(0)
        assert_streams(got, reference_epoch(p, 0))
        assert_streams(list(svc.epoch(1)), reference_epoch(p, 1))
        assert len(svc.coordinator.alive()) == 1
        assert svc.coordinator.retired == []  # no respawn asked for


def test_respawn_restores_fleet_width(p):
    needs_fork()
    with service(p, num_workers=2, respawn=True) as svc:
        got = []
        for i, g in enumerate(svc.epoch(0)):
            got.append(g)
            if i == 1:
                svc.kill_worker(0)
        assert_streams(got, reference_epoch(p, 0))
        assert_streams(list(svc.epoch(1)), reference_epoch(p, 1))
        alive = svc.coordinator.alive()
        assert len(alive) == 2 and all(w.process_alive() for w in alive)
        assert len(svc.coordinator.retired) == 1
        marks = svc.watermarks()
        assert marks[0] is not None and marks[0][0] == 1, marks


def test_dead_fleet_and_worker_error_raise_at_the_consumer(p):
    needs_fork()
    with service(p, num_workers=1) as svc:
        svc.kill_worker(0)
        svc.coordinator.workers[0].process.join(5.0)
        with pytest.raises(DeadFleetError):
            list(svc.epoch(0))

    class Broken(type(p.tstore)):
        def neighbors_batch(self, edge_set, nodes):
            raise KeyError(f"no shard holds {edge_set}")

    broken = Broken(p.tstore.schema, p.tstore.edges, p.tstore.node_features,
                    p.tstore.num_nodes)
    with SamplingService(broken, p.tspec, p.roots, batch_size=8,
                         sizes=p.sizes, num_workers=1, seed=0) as svc:
        with pytest.raises(RuntimeError,
                           match="sampler worker 0 failed: KeyError"):
            list(svc.epoch(0))


def test_close_is_bounded_and_reaps_every_child(p):
    """close() on a fleet mid-epoch (workers blocked in sendall) joins
    every worker, the replaced ones included, within its timeout."""
    needs_fork()
    svc = service(p, num_workers=3, respawn=True)
    try:
        it = svc.epoch(0)
        next(it)
        svc.kill_worker(2)
        next(it)
        procs = list(svc._spawned)
    finally:
        svc.close(timeout=5.0)
    assert len(procs) >= 3
    assert not any(proc.is_alive() for proc in procs)
    with pytest.raises(RuntimeError, match="closed"):
        next(svc.epoch(0))


def test_watermarks_track_progress(p):
    with service(p, num_workers=2, backend="thread") as svc:
        list(svc.epoch(0))
        marks = svc.watermarks()
        assert set(marks) == {0, 1}
        assert all(m is not None and m[0] == 0 for m in marks.values())


# ---------------------------------------------------------------------------
# ServiceProvider and runner.run(sampler="service")
# ---------------------------------------------------------------------------

def test_service_provider_own_and_label_fn(p):
    task = RootNodeMulticlassClassification("paper", 8, 16)
    for sort in (True, False):
        svc = service(p, num_workers=1, backend="thread", num_replicas=None,
                      edges_sorted_by_target=sort)
        try:
            shared = ServiceProvider(svc, label_fn=task.labels)
            assert shared.edges_sorted_by_target is sort
            assert shared.num_steps == svc.num_steps == 8
            pairs = list(shared.epoch(0, start_step=5))
            want = list(GraphBatcher(p.tg, 8, p.sizes, seed=0,
                                     edges_sorted_by_target=sort).epoch(0))
            assert_streams([g for g, _ in pairs], want[5:])
            for (g, lab), w in zip(pairs, want[5:]):
                np.testing.assert_array_equal(lab, task.labels(w))
            shared.close()  # not owned: the fleet stays up
            assert len(list(svc.epoch(1))) == 8
            owner = ServiceProvider(svc, own=True)
            assert_streams(list(owner.epoch(0)), want)
            owner.close()
            with pytest.raises(RuntimeError, match="closed"):
                next(svc.epoch(0))
        finally:
            svc.close()
    assert ServiceProvider(iter(())).edges_sorted_by_target is None


class JInit(JModule):
    def __init__(self, dim):
        self.paper = JLinear(32, dim)

    def init(self, key):
        return {"paper": self.paper.init(key)}

    def __call__(self, params, graph):
        return graph.replace_features(node_sets={
            "paper": {J_HIDDEN: jax.nn.relu(self.paper(
                params["paper"], graph.node_sets["paper"]["feat"]))}})


class TInit(torch.nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.paper = Linear(32, dim)

    def forward(self, graph):
        return graph.replace_features(node_sets={
            "paper": {HIDDEN_STATE: torch.relu(self.paper(
                graph.node_sets["paper"]["feat"]))}})


def test_runner_service_path_matches_the_jax_runner(p):
    """Both runners over a fleet of the same plan, from the same draw:
    the JAX runner once per step count (it reports only the last loss),
    the port's once."""
    dim, steps = 16, 3
    edges = {"cites": ("paper", "paper")}
    jtask = JRootTask("paper", 8, dim)
    task = RootNodeMulticlassClassification("paper", 8, dim)

    def jgnn():
        return j_vanilla_mpnn(edges, {"paper": dim}, message_dim=dim,
                              hidden_dim=dim, num_rounds=2)

    initial = jax.tree_util.tree_map(np.asarray, JTrainer(
        seed=0)._init_params(JInit(dim), jgnn(), jtask.head()))
    kw = dict(task=None, learning_rate=3e-3, total_steps=10,
              log_every=10 ** 6, sampler="service", label_fn=None)
    want, want_params = [], None
    with JService(p.jstore, p.jspec, p.roots, batch_size=8, sizes=p.sizes,
                  num_workers=2, seed=0, backend="thread") as jsvc:
        for k in range(1, steps + 1):
            res = j_run(**{**kw, "task": jtask, "label_fn": jtask.labels},
                        model_fn=lambda: (JInit(dim), jgnn()), service=jsvc,
                        max_steps=k)
            want.append(res.train_loss)
            want_params = res.metrics["params"]
    with service(p, num_workers=2, backend="thread",
                 num_replicas=None) as svc:
        got = t_runner.run(
            **{**kw, "task": task, "label_fn": task.labels},
            model_fn=lambda: (TInit(dim), vanilla_mpnn(
                edges, {"paper": dim}, message_dim=dim, hidden_dim=dim,
                num_rounds=2)),
            service=svc, max_steps=steps, device="cpu", params=initial)
    assert got.step == steps
    np.testing.assert_allclose(got.metrics["train_losses"], want,
                               rtol=1e-4, atol=1e-5)
    flat_want = flat(want_params)
    got_params = {k: v.numpy() for k, v in got.metrics["params"].items()}
    assert sorted(got_params) == sorted(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_allclose(got_params[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def flat(tree, prefix=""):
    """A reference parameter tree as {dotted name: array}, named as the
    port's ``named_parameters`` are."""
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def test_runner_validates_arguments_as_the_reference():
    for bad, match in ((dict(sampler="service"), "needs service="),
                       (dict(sampler="service", service=object()),
                        "label_fn"),
                       (dict(sampler="in_process"), "train_batches"),
                       (dict(sampler="bogus"), "unknown sampler")):
        with pytest.raises(ValueError, match=match):
            t_runner.run(model_fn=None, task=None, **bad)
        with pytest.raises(ValueError, match=match):
            j_run(model_fn=None, task=None, **bad)
