"""The port's multi-host sampling (`repro_torch.sampling_service.remote`,
per-rank streams onto the mesh, the twin's ``--multihost`` and
multi-rank ``--sampler service``) against its plain versions and the
JAX package, on the CPU over loopback TCP.

* The endpoint and client tests of tests/test_multihost.py, on the
  port's classes: per-rank streams equal the per-rank batchers; a
  reconnect mid-epoch resumes bit for bit (and a resume inside the
  replay window is served from it); a fleet killed mid-epoch still
  streams bit for bit; ``start_step`` resumes; a dead endpoint raises
  instead of hanging; an endpoint killed mid-epoch raises at the
  consumer; a source error surfaces at the consumer; close joins every
  thread, promptly even when a fleet forked after the client connected
  holds copies of its sockets; the client's close is prompt and
  idempotent.
* Interop, array for array: the port's client reads the reference's
  endpoint, and the reference's client reads the port's endpoint.
* Per-rank streams are the global groups: rank ``r`` of a (data=R,
  model=M) mesh reading ``GraphBatcher(rank=r // M, world=R,
  num_replicas=1)`` gets group ``r // M`` of the global super-batch,
  and `MeshPlan.put_super_batch` places either one identically, at full
  width.
* The twin: ``--multihost 4`` on the (2, 2) mesh reaches the JAX
  example's final loss and test accuracy (1e-4, from the JAX initial
  parameters); ``--sampler service --num-devices 2`` repeats the
  in-process 2-rank losses exactly; a launch whose ranks fail exits
  non-zero with ``multihost: FAILED`` and each rank's log tail, and
  leaves no process behind; ``--multihost 2 --num-devices 4`` raises.

Every socket read carries a timeout, every endpoint and client is closed
in a ``with`` block or a ``finally``, and ports are OS-assigned.
"""
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mesh_ranks as R  # noqa: E402 — its directory is on the path
from test_torch_mesh import (TWIN_ARGS,  # noqa: E402,F401 — a fixture
                             jax_example)

from repro.data import GraphBatcher as JBatcher  # noqa: E402
from repro.data import InMemorySampler as JSampler  # noqa: E402
from repro.data import SamplingSpecBuilder as JSpecBuilder  # noqa: E402
from repro.data import find_size_constraints as j_find_sizes  # noqa: E402
from repro.core.schema import mag_schema as j_mag_schema  # noqa: E402
from repro.data.synthetic import synthetic_mag as j_synthetic_mag  # noqa: E402
from repro.sampling_service import RemoteStreamClient as JClient  # noqa: E402
from repro.sampling_service import SamplerEndpoint as JEndpoint  # noqa: E402

from repro_torch.core.graph_tensor import (stack_size,  # noqa: E402
                                           unstack_graph)
from repro_torch.core.schema import mag_schema  # noqa: E402
from repro_torch.data.batching import find_size_constraints  # noqa: E402
from repro_torch.data.pipeline import GraphBatcher  # noqa: E402
from repro_torch.data.sampling import (InMemorySampler,  # noqa: E402
                                       SamplingSpecBuilder)
from repro_torch.data.serialization import graph_to_flat  # noqa: E402
from repro_torch.data.synthetic import synthetic_mag  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.distributed.collectives import Axis  # noqa: E402
from repro_torch.orchestration import ogbn_mag_train  # noqa: E402
from repro_torch.orchestration.providers import (  # noqa: E402
    BatcherProvider, IteratorProvider, ServiceProvider, source_rows)
from repro_torch.orchestration.trainer import Trainer  # noqa: E402
from repro_torch.sampling_service import (RemoteStreamClient,  # noqa: E402
                                          SamplerEndpoint, SamplingService)

STORE_KW = dict(n_papers=200, n_authors=90, n_institutions=8, n_fields=24,
                n_classes=8, feat_dim=32)


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


def _spec(builder, schema):
    b = builder(schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(8, "cites")
    cited.join([seed_op]).sample(4, "written")
    return seed_op.build()


@pytest.fixture(scope="module")
def problem():
    store, _ = synthetic_mag(**STORE_KW)
    spec = _spec(SamplingSpecBuilder, mag_schema())
    roots = list(range(48))
    graphs = InMemorySampler(store, spec, seed=0).sample(roots)
    sizes = find_size_constraints(graphs, 8)
    return store, spec, roots, graphs, sizes


def _batcher_source(graphs, sizes, *, world):
    def factory(rank):
        return GraphBatcher(graphs, 16, sizes, seed=0, rank=rank,
                            world=world)
    return factory


def _threads_back_to(n_before, timeout=10.0):
    deadline = time.monotonic() + timeout
    while threading.active_count() > n_before \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= n_before


# ---------------------------------------------------------------------------
# endpoint + remote client, as tests/test_multihost.py holds the reference
# ---------------------------------------------------------------------------

@pytest.mark.timeout(180)
def test_endpoint_streams_match_per_rank_batchers(problem):
    store, spec, roots, graphs, sizes = problem
    sizes16 = find_size_constraints(graphs, 16)
    world = 2
    with SamplerEndpoint(_batcher_source(graphs, sizes16,
                                         world=world)) as ep:
        for rank in range(world):
            want = list(GraphBatcher(graphs, 16, sizes16, seed=0,
                                     rank=rank, world=world).epoch(0))
            with RemoteStreamClient(ep.address, rank) as client:
                assert client.num_steps == len(want)
                got = list(client.epoch(0))
            assert_streams(got, want)


@pytest.mark.timeout(180)
def test_endpoint_reconnect_mid_epoch_resumes_bit_identical(problem):
    """Sever the TCP connection after the first delivered batch: the
    client redials, resumes from its watermark, and the full stream
    equals the in-process batcher's — no loss, no duplicates."""
    store, spec, roots, graphs, sizes = problem
    sizes16 = find_size_constraints(graphs, 16)
    with SamplerEndpoint(_batcher_source(graphs, sizes16, world=1)) as ep:
        client = RemoteStreamClient(ep.address, 0, heartbeat_timeout=1.0,
                                    connect_deadline=20.0)
        try:
            got = []
            for i, g in enumerate(client.epoch(0)):
                got.append(g)
                if i == 0:  # yank the wire under the reader thread
                    with client._sock_lock:
                        if client._sock is not None:
                            client._sock.shutdown(socket.SHUT_RDWR)
            want = list(GraphBatcher(graphs, 16, sizes16,
                                     seed=0).epoch(0))
            assert_streams(got, want)
        finally:
            client.close()


@pytest.mark.timeout(180)
def test_endpoint_fleet_kill_mid_epoch_over_tcp(problem):
    """SamplingService fleets behind a TCP endpoint, a sampler worker
    killed mid-epoch: the coordinator rebalances below, TCP streams
    above, and the stream stays bit-identical."""
    store, spec, roots, graphs, sizes = problem
    services = {}

    def factory(rank):
        services[rank] = SamplingService(
            store, spec, roots, batch_size=8, sizes=sizes, num_workers=2,
            num_replicas=1, seed=0, base_seed=0)
        return services[rank]

    batcher = GraphBatcher(graphs, 8, sizes, seed=0, num_replicas=1)
    with SamplerEndpoint(factory) as ep:
        with RemoteStreamClient(ep.address, 0) as client:
            got = []
            for i, g in enumerate(client.epoch(0)):
                got.append(g)
                if i == 1:
                    services[0].kill_worker(0)
            assert_streams(got, list(batcher.epoch(0)))


@pytest.mark.timeout(180)
def test_endpoint_start_step_resume_matches(problem):
    store, spec, roots, graphs, sizes = problem
    sizes16 = find_size_constraints(graphs, 16)
    with SamplerEndpoint(_batcher_source(graphs, sizes16, world=1)) as ep:
        with RemoteStreamClient(ep.address, 0) as client:
            got = list(client.epoch(0, start_step=2))
        want = list(GraphBatcher(graphs, 16, sizes16,
                                 seed=0).epoch(0, start_step=2))
        assert len(want) == 1
        assert_streams(got, want)


@pytest.mark.timeout(120)
def test_resume_inside_the_replay_window_is_served_from_cache(problem):
    """A second HELLO for steps the endpoint sent last is answered with
    the cached frame bytes, not resampled: the same stream, and the
    endpoint counts each replayed step."""
    store, spec, roots, graphs, sizes = problem
    sizes16 = find_size_constraints(graphs, 16)
    want = list(GraphBatcher(graphs, 16, sizes16, seed=0).epoch(0))
    with SamplerEndpoint(_batcher_source(graphs, sizes16, world=1)) as ep:
        with RemoteStreamClient(ep.address, 0) as client:
            assert_streams(list(client.epoch(0)), want)
            assert ep.replay_stats() == {0: 0}
            assert_streams(list(client.epoch(0, start_step=1)), want[1:])
        assert ep.replay_stats() == {0: len(want) - 1}


@pytest.mark.timeout(60)
def test_dead_endpoint_raises_instead_of_hanging():
    """No listener at all: the client raises ConnectionError within its
    connect deadline; close() returns promptly with no leaked thread."""
    n_before = threading.active_count()
    client = RemoteStreamClient(("127.0.0.1", 1), 0, connect_deadline=1.0)
    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        list(client.epoch(0))
    assert time.monotonic() - t0 < 15.0
    client.close()
    _threads_back_to(n_before, 5.0)


class _SlowSource:
    """Batcher wrapper that produces one step per `delay` seconds, so an
    endpoint killed mid-epoch has not flushed the rest of the stream
    into socket buffers."""

    def __init__(self, inner, delay: float):
        self.inner = inner
        self.delay = delay

    @property
    def num_steps(self):
        return self.inner.num_steps

    def epoch(self, epoch, *, start_step=0):
        for g in self.inner.epoch(epoch, start_step=start_step):
            time.sleep(self.delay)
            yield g


@pytest.mark.timeout(120)
def test_endpoint_killed_mid_epoch_raises_at_consumer(problem):
    """The endpoint dies mid-epoch and never comes back: the consumer
    gets ConnectionError after the reconnect deadline."""
    store, spec, roots, graphs, sizes = problem
    sizes16 = find_size_constraints(graphs, 16)
    ep = SamplerEndpoint(lambda rank: _SlowSource(
        GraphBatcher(graphs, 16, sizes16, seed=0), 0.5))
    client = RemoteStreamClient(ep.address, 0, heartbeat_timeout=0.5,
                                connect_deadline=2.0)
    try:
        with pytest.raises(ConnectionError):
            for i, _ in enumerate(client.epoch(0)):
                if i == 0:
                    ep.close()  # the endpoint is gone for good
    finally:
        t0 = time.monotonic()
        client.close()
        assert time.monotonic() - t0 < 10.0  # the join is timed
        ep.close()


@pytest.mark.timeout(60)
def test_endpoint_source_error_surfaces_at_consumer(problem):
    """A batch-source failure is not a transport problem: the endpoint
    ships it as an ERROR frame and the consumer gets the RuntimeError,
    not a reconnect loop ending in ConnectionError."""
    store, spec, roots, graphs, sizes = problem
    sizes16 = find_size_constraints(graphs, 16)

    class Boom:
        num_steps = 3

        def epoch(self, epoch, *, start_step=0):
            inner = GraphBatcher(graphs, 16, sizes16, seed=0)
            for i, g in enumerate(inner.epoch(epoch,
                                              start_step=start_step)):
                if i + start_step >= 1:
                    raise RuntimeError("sampler exploded")
                yield g

    with SamplerEndpoint(lambda rank: Boom()) as ep:
        with RemoteStreamClient(ep.address, 0,
                                connect_deadline=5.0) as client:
            with pytest.raises(RuntimeError, match="sampler exploded"):
                list(client.epoch(0))


@pytest.mark.timeout(120)
def test_client_close_mid_epoch_joins_reader_thread(problem):
    store, spec, roots, graphs, sizes = problem
    sizes16 = find_size_constraints(graphs, 16)
    with SamplerEndpoint(_batcher_source(graphs, sizes16, world=1)) as ep:
        # after the endpoint is up (its accept thread lives as long): the
        # client's reader and the endpoint's handler and heartbeat
        # threads must all be gone again after close()
        n_before = threading.active_count()
        client = RemoteStreamClient(ep.address, 0)
        it = client.epoch(0)
        next(it)          # the stream is live, the reader mid-flight
        it.close()        # generator close joins the reader
        client.close()
        _threads_back_to(n_before)
        # a closed client refuses new epochs instead of wedging
        with pytest.raises(RuntimeError):
            next(client.epoch(0))


@pytest.mark.timeout(60)
def test_endpoint_close_joins_accept_thread(problem):
    """close() reaps the accept thread: closing a listening socket does
    not wake a blocked accept() on Linux, so the loop polls."""
    store, spec, roots, graphs, sizes = problem
    sizes16 = find_size_constraints(graphs, 16)
    n_before = threading.active_count()
    ep = SamplerEndpoint(_batcher_source(graphs, sizes16, world=1))
    assert threading.active_count() > n_before  # the accept thread
    ep.close()
    _threads_back_to(n_before, 5.0)


@pytest.mark.timeout(60)
def test_endpoint_close_is_prompt_over_a_forked_fleet(problem):
    """The fleet forks at the first HELLO, so its workers hold copies of
    the client's and the handler's sockets: the client's close still
    ends the connection, and the endpoint's close joins its handler at
    once instead of waiting out the join timeout (the reference's
    close() alone takes 5 s here)."""
    store, spec, roots, graphs, sizes = problem
    n_before = threading.active_count()
    ep = SamplerEndpoint(lambda rank: SamplingService(
        store, spec, roots, batch_size=8, sizes=sizes, num_workers=2,
        num_replicas=1, seed=0))
    try:
        with RemoteStreamClient(ep.address, 0) as client:
            it = client.epoch(0)
            next(it)
            it.close()
    finally:
        t0 = time.monotonic()
        ep.close()
        assert time.monotonic() - t0 < 2.0
    _threads_back_to(n_before, 5.0)


@pytest.mark.timeout(60)
def test_client_close_is_prompt_and_idempotent(problem):
    """close() during use returns at once, twice, and later epochs
    raise instead of blocking on a closed socket."""
    store, spec, roots, graphs, sizes = problem
    sizes16 = find_size_constraints(graphs, 16)
    with SamplerEndpoint(lambda rank: _SlowSource(
            GraphBatcher(graphs, 16, sizes16, seed=0), 0.2)) as ep:
        client = RemoteStreamClient(ep.address, 0)
        it = client.epoch(0)
        next(it)
        t0 = time.monotonic()
        client.close()
        client.close()  # idempotent
        assert time.monotonic() - t0 < 5.0
        it.close()
        with pytest.raises(RuntimeError, match="closed"):
            list(client.epoch(1))


# ---------------------------------------------------------------------------
# interop with the reference: the frames are the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def j_problem():
    store, _ = j_synthetic_mag(**STORE_KW)
    spec = _spec(JSpecBuilder, j_mag_schema())
    graphs = JSampler(store, spec, seed=0).sample(list(range(48)))
    return graphs, j_find_sizes(graphs, 16)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("world", [1, 2])
def test_port_client_reads_the_reference_endpoint(problem, j_problem,
                                                  world):
    graphs, sizes = j_problem
    want_port = problem[3]
    with JEndpoint(lambda r: JBatcher(graphs, 16, sizes, seed=0, rank=r,
                                      world=world)) as ep:
        for rank in range(world):
            want = list(JBatcher(graphs, 16, sizes, seed=0, rank=rank,
                                 world=world).epoch(1))
            with RemoteStreamClient(ep.address, rank) as client:
                assert client.num_steps == len(want)
                got = list(client.epoch(1))
            assert_streams(got, want)
            # and the port's own batcher gives the same stream
            assert_streams(got, list(GraphBatcher(
                want_port, 16, find_size_constraints(want_port, 16),
                seed=0, rank=rank, world=world).epoch(1)))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("world", [1, 2])
def test_reference_client_reads_the_port_endpoint(problem, j_problem,
                                                  world):
    graphs = problem[3]
    sizes16 = find_size_constraints(graphs, 16)
    j_graphs, j_sizes = j_problem
    with SamplerEndpoint(_batcher_source(graphs, sizes16,
                                         world=world)) as ep:
        for rank in range(world):
            client = JClient(ep.address, rank)
            try:
                assert client.num_steps == 48 // 16
                got = list(client.epoch(0, start_step=1))
            finally:
                client.close()
            assert_streams(got, list(JBatcher(
                j_graphs, 16, j_sizes, seed=0, rank=rank,
                world=world).epoch(0, start_step=1)))


# ---------------------------------------------------------------------------
# per-rank streams onto the mesh
# ---------------------------------------------------------------------------

def _plan(rank, data, model):
    """Rank `rank`'s MeshPlan of a (data, model) mesh, built without a
    process group (placement runs no collective)."""
    row, col = divmod(rank, model)
    grid = np.arange(data * model).reshape(data, model)
    axes = {"data": Axis("data", data, row, tuple(grid[:, col]), None),
            "model": Axis("model", model, col, tuple(grid[row]), None)}
    mesh = partition.Mesh(("data", "model"), {"data": data, "model": model},
                          rank, axes, Axis("world", data * model, rank,
                                           tuple(range(data * model)),
                                           None), "none")
    return partition.plan_for(mesh, device="cpu")


def _labels(graph):
    return np.arange(stack_size(graph))[:, None] * 10 + np.arange(3)


@pytest.mark.parametrize("data,model", [(2, 1), (2, 2), (4, 1), (1, 2)])
def test_rank_streams_are_the_global_groups(problem, data, model):
    """Rank r's shard stream equals group r // M of the global
    super-batch, leaf for leaf, and `put_super_batch` places the global
    super-batch and the rank's shard identically, at full width."""
    graphs, sizes = problem[3], problem[4]
    per_group = find_size_constraints(graphs, 16 // data)
    glob = list(GraphBatcher(graphs, 16, per_group, seed=0,
                             num_replicas=data).epoch(1))
    for rank in range(data * model):
        row = rank // model
        mine = list(GraphBatcher(graphs, 16, per_group, seed=0, rank=row,
                                 world=data, num_replicas=1).epoch(1))
        assert len(mine) == len(glob) == 3
        plan = _plan(rank, data, model)
        for g, m in zip(glob, mine):
            assert stack_size(m) == 1
            assert_same(unstack_graph(g)[row], unstack_graph(m)[0])
            placed_g, lab_g = plan.put_super_batch(g, _labels(g))
            placed_m, lab_m = plan.put_super_batch(m, _labels(m) + row * 10)
            assert stack_size(placed_g) == stack_size(placed_m) == 1
            assert_same(placed_g, placed_m)
            # full width: every placed leaf has its host leaf's shape
            assert {k: tuple(v.shape) for k, v in
                    graph_to_flat(placed_g).items()} == {
                k: v.shape for k, v in graph_to_flat(m).items()}
            assert lab_g.tolist() == lab_m.tolist()


def test_put_super_batch_group_counts():
    """A multiple of the data size is global, one group is the rank's
    row, any other count raises."""
    plan = _plan(1, 2, 1)
    assert plan.local_data_size(4) == 2
    assert plan.local_data_size(2) == 2
    assert plan.local_data_size(1) == 1
    with pytest.raises(ValueError, match="3 component groups"):
        plan.local_data_size(3)
    assert _plan(0, 1, 2).local_data_size(1) == 1


def _one_group_sources(gs, sizes, bs):
    return {
        "scalar": BatcherProvider(gs, bs, sizes, num_replicas=None),
        "global": BatcherProvider(gs, bs, sizes, num_replicas=1),
        "global service": ServiceProvider(GraphBatcher(
            gs, bs, sizes, seed=0, num_replicas=1)),
    }


@pytest.mark.parametrize("source", ["scalar", "global", "global service"])
def test_one_group_batches_of_all_the_roots_raise_at_data_2(monkeypatch,
                                                            source):
    """At data=2 a one-group batch is a rank's row only from a source
    split into 2 rows; an unstacked graph, or one group of a stream of
    all the roots, raises before any step instead of every rank training
    the same group."""
    gs, _ = R.graphs()
    prov = _one_group_sources(gs, find_size_constraints(gs, R.BATCH),
                              R.BATCH)[source]
    assert source_rows(prov) == 1
    monkeypatch.setattr(Trainer, "_make_plan",
                        lambda self, device: _plan(0, 2, 1))
    trainer = Trainer(learning_rate=R.LR, device="cpu", num_devices=2,
                      log_every=10 ** 6)
    match = "unstacked graph" if source == "scalar" else \
        "one-group batch from a stream of 1 data row"
    with pytest.raises(ValueError, match=match):
        trainer.fit(R.model_fn, R.task(), prov)


def test_source_rows_of_per_rank_streams():
    """A per-row batcher or fleet is one of `world` rows; a remote
    stream or a generator shows no plan, and the Trainer takes what
    it yields."""
    gs, sizes = R.graphs()
    assert source_rows(BatcherProvider(gs, R.BATCH, sizes, rank=1,
                                       world=2, num_replicas=1)) == 2
    assert source_rows(ServiceProvider(GraphBatcher(
        gs, R.BATCH, sizes, seed=0, rank=1, world=2,
        num_replicas=1))) == 2
    assert source_rows(ServiceProvider(RemoteStreamClient(
        ("127.0.0.1", 1), 1))) is None
    assert source_rows(IteratorProvider(lambda e: iter(()))) is None
    with pytest.raises(ValueError, match="unstacked graph"):
        _plan(1, 2, 1).put_super_batch(gs[0], np.zeros(1))


# ---------------------------------------------------------------------------
# the twin: --multihost and the multi-rank service
# ---------------------------------------------------------------------------

SMALL = ["--papers", "96", "--steps", "2", "--device", "cpu",
         "--hidden", "16"]


@pytest.mark.timeout(600)
def test_multihost_twin_matches_the_jax_example(jax_example, tmp_path,
                                                capsys):
    """Four processes of one (2, 2) world, rank 0 hosting the endpoint
    and its four row fleets, every rank streaming over TCP: the JAX
    example's final loss and test accuracy (its 1-process run)."""
    init, want = jax_example
    got = ogbn_mag_train.run_twin(
        TWIN_ARGS + ["--device", "cpu", "--init-params", init,
                     "--multihost", "4",
                     "--multihost-log-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "multihost: OK" in out
    assert "service over TCP sampler" in out
    assert got["steps"] == want["steps"] == 3
    assert got["backend"] == "gloo"
    assert abs(got["final_loss"] - want["loss"]) < 1e-4, (got, want)
    assert abs(got["test_accuracy"] - want["accuracy"]) < 1e-4, (got, want)
    assert len(got["ranks"]) == 4
    for rank in got["ranks"]:   # one collective: the same on every rank
        assert rank["losses"] == got["losses"]
    assert sorted(os.listdir(tmp_path)) == [f"rank{r}.log" for r in range(4)]


@pytest.mark.timeout(300)
def test_multi_rank_service_repeats_in_process():
    inproc = ogbn_mag_train.run_twin(SMALL + ["--num-devices", "2"])
    service = ogbn_mag_train.run_twin(SMALL + ["--num-devices", "2",
                                               "--sampler", "service"])
    assert inproc["steps"] == service["steps"] == 2
    for a, b in zip(inproc["ranks"], service["ranks"]):
        assert a["losses"] == b["losses"]
        assert a["test_accuracy"] == b["test_accuracy"]
    assert service["backend"] == "gloo"


def _processes_naming(marker: str) -> list:
    """Live pids whose command line holds `marker` (a forked sampler
    worker keeps its parent's)."""
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if marker in cmd and state != "Z":
            pids.append(int(pid))
    return pids


@pytest.mark.timeout(300)
def test_launcher_fails_cleanly(tmp_path, capsys):
    """Ranks that fail: the launcher exits non-zero, prints each rank's
    exit and log tail and ``multihost: FAILED``, and no process of the
    run is left."""
    logs = tmp_path / "logs"
    with pytest.raises(SystemExit) as exc:
        ogbn_mag_train.main(SMALL + [
            "--num-devices", "2", "--multihost", "2",
            "--init-params", str(tmp_path / "missing.npz"),
            "--multihost-log-dir", str(logs)])
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    assert out.rstrip().endswith("multihost: FAILED")
    assert "ogbn_mag_train OK" not in out
    for r in range(2):
        assert f"--- rank {r} exit " in out
    assert "missing.npz" in out   # the failing rank's log tail
    assert _processes_naming(str(logs)) == []


def test_multihost_count_must_equal_num_devices():
    with pytest.raises(SystemExit, match="one rank on one device"):
        ogbn_mag_train.run_twin(["--multihost", "2", "--num-devices", "4",
                                 "--device", "cpu"])
