"""The port's serving remainder against the JAX package, on the CPU, and
its per-rung CUDA graphs on the card.

* `repro_torch.serve.loadgen` vs `repro.serve.loadgen`: through a stub
  server that fulfils at once and records every submitted root, both
  offer the same root sequences (per client in the closed loop, thread
  names included) and the same offered QPS under seeds 0 and 1; on
  identical latencies `LoadReport`'s percentiles, QPS and summary are
  equal.
* The engine lifecycle, mirrored from tests/test_serve_gnn.py on
  `GNNServer(device="cpu")` with a torch stand-in model: embedding-cache
  hits and invalidation on a version bump, `close()` failing pending
  requests without hanging, a bad request failing alone, a full queue
  failing fast, and closed/open-loop reports on a live server.  Every
  wait is bounded.
* The twin `repro_torch.orchestration.gnn_serve` against the JAX
  example's pieces (same store, spec and parameters): `serve_sync([1, 2,
  3])` logits within rtol 1e-4 / atol 1e-5 (fp32 sums in another order),
  and the freshness step in both.
* `cuda` (skips without a card): each rung's graph replay against the
  eager forward within rtol/atol 1e-5 (the served batches are unsorted,
  so the edge kernel's fp32 atomics land in any order), no capture after
  warmup (a server without warmup captures a rung when first served, and
  counts it), no kernel launch counted on replay, and a capture that
  meets a host sync raises.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.schema import (EdgeSetSpec, FeatureSpec, GraphSchema,
                                     NodeSetSpec)
from repro_torch.data.sampling import SamplingSpecBuilder
from repro_torch.orchestration import gnn_serve
from repro_torch.serve import loadgen as t_loadgen
from repro_torch.serve.cache import VersionedGraphStore
from repro_torch.serve.gnn import EngineClosed, GNNServer, ServeError


def _j_loadgen():
    """The reference's loadgen (imported here, not at the top, so that
    the `cuda` test runs where there is no JAX)."""
    from repro.serve import loadgen
    return loadgen


# ---------------------------------------------------------------------------
# loadgen vs the reference, through a stub server
# ---------------------------------------------------------------------------

class _StubRequest:
    def __init__(self):
        self.submitted_at = self.done_at = time.perf_counter()

    def result(self, timeout=None):
        return 0.0

    @property
    def latency_s(self):
        return self.done_at - self.submitted_at


class _RecordingServer:
    """Fulfils every request at once; records (thread name, root)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.offered = []

    def submit(self, root):
        with self.lock:
            self.offered.append((threading.current_thread().name, root))
        return _StubRequest()

    def per_thread(self) -> dict:
        out = {}
        for name, root in self.offered:
            out.setdefault(name, []).append(root)
        return out


ROOTS = list(range(100, 160))


@pytest.mark.parametrize("seed", [0, 1])
def test_closed_loop_offers_the_reference_sequences(seed):
    offered = {}
    for name, mod in (("ref", _j_loadgen()), ("port", t_loadgen)):
        server = _RecordingServer()
        rep = mod.closed_loop(server, ROOTS, clients=3,
                              requests_per_client=17, seed=seed, timeout=5)
        assert rep.completed == 51 and rep.errors == 0
        offered[name] = server.per_thread()
    assert sorted(offered["port"]) == [f"loadgen-client-{i}"
                                       for i in range(3)]
    assert offered["port"] == offered["ref"]


@pytest.mark.parametrize("seed", [0, 1])
def test_open_loop_offers_the_reference_sequence(seed):
    offered, reports = {}, {}
    for name, mod in (("ref", _j_loadgen()), ("port", t_loadgen)):
        server = _RecordingServer()
        reports[name] = mod.open_loop(server, ROOTS, qps=400.0,
                                      duration_s=0.25, seed=seed, timeout=5)
        offered[name] = server.offered
    assert {t for t, _ in offered["port"]} == {"loadgen-open-loop"}
    assert offered["port"] == offered["ref"]
    assert reports["port"].offered_qps == reports["ref"].offered_qps
    assert reports["port"].completed == reports["ref"].completed \
        == len(offered["port"])


def test_load_report_numbers_equal_the_reference():
    lat = tuple(np.random.default_rng(5).exponential(3.0, 97).tolist())
    for kw in (dict(mode="closed_loop"),
               dict(mode="open_loop", offered_qps=123.456)):
        kw.update(completed=97, errors=2, duration_s=1.7, latencies_ms=lat)
        ref = _j_loadgen().LoadReport(**kw)
        port = t_loadgen.LoadReport(**kw)
        assert port.qps == ref.qps
        for q in (0.0, 50.0, 90.0, 99.0, 100.0):
            assert port.percentile_ms(q) == ref.percentile_ms(q)
        assert (port.p50_ms, port.p99_ms) == (ref.p50_ms, ref.p99_ms)
        assert port.summary() == ref.summary()
    empty = t_loadgen.LoadReport("open_loop", 0, 0, 0.0, ())
    assert (empty.qps, empty.p99_ms) == (0.0, 0.0)


# ---------------------------------------------------------------------------
# the engine lifecycle on GNNServer(device="cpu")
# ---------------------------------------------------------------------------

def tiny_schema() -> GraphSchema:
    return GraphSchema(
        node_sets={"n": NodeSetSpec({"feat": FeatureSpec("float32", (4,))})},
        edge_sets={"e": EdgeSetSpec("n", "n")})


def tiny_store(n_nodes: int = 10) -> VersionedGraphStore:
    """Ring graph i -> i+1 (mod n), as tests/test_serve_gnn.py builds it:
    an appended edge provably lands in the resampled subgraph."""
    src = np.arange(n_nodes, dtype=np.int64)
    tgt = (src + 1) % n_nodes
    feats = np.arange(n_nodes * 4, dtype=np.float32).reshape(n_nodes, 4)
    return VersionedGraphStore(tiny_schema(), {"e": (src, tgt)},
                               {"n": {"feat": feats}}, {"n": n_nodes})


def tiny_spec():
    b = SamplingSpecBuilder(tiny_schema())
    b.seed("n").sample(4, "e")
    return b._build()


def sum_apply(graph):
    """Torch stand-in model: per-component sum of node features
    (component-major rows, like a root readout head)."""
    ns = graph.node_sets["n"]
    out = torch.zeros(graph.num_components + 1, 4)
    out.index_add_(0, ns.component_ids(), ns["feat"])
    return out[:-1]


def make_server(store=None, apply_fn=sum_apply, **kwargs):
    kwargs.setdefault("max_batch", 4)
    kwargs.setdefault("batch_window_ms", 1.0)
    return GNNServer(store if store is not None else tiny_store(),
                     tiny_spec(), apply_fn, device="cpu", **kwargs)


def test_cpu_server_runs_eagerly():
    """A server on the CPU captures nothing: `run_batch` is `run_eager`,
    and the compile count is bucket accounting."""
    from repro_torch.data.grouping import merge_and_pad
    with make_server() as server:
        assert not server.capture_graphs and not server._graphs
        merged = merge_and_pad([server._subgraphs.get(r) for r in (1, 2, 3)],
                               server.ladder.sizes[4])
        np.testing.assert_array_equal(server.run_batch(merged),
                                      server.run_eager(merged))
        server.serve_sync([4, 5, 6], timeout=10)
        assert server.steady_state_recompiles == 0


def test_embedding_cache_hits_and_version_invalidation():
    store = tiny_store()
    with make_server(store) as server:
        first = server.submit(5)
        v1 = np.asarray(first.result(10))
        assert not first.cache_hit
        again = server.submit(5)
        np.testing.assert_array_equal(np.asarray(again.result(10)), v1)
        assert again.cache_hit  # fulfilled synchronously from the cache
        assert server.stats.embedding_hits == 1

        store.add_edges("e", [5], [0])  # ring: adds a second out-edge
        fresh = server.submit(5)
        v2 = np.asarray(fresh.result(10))
        assert not fresh.cache_hit
        assert server.stats.invalidations > 0
        # the new neighbour's features join the component sum
        assert not np.allclose(v1, v2)


def test_close_fails_pending_requests_never_hangs():
    """Wedge the engine inside the model: a request stuck behind it
    errors with EngineClosed promptly instead of hanging."""
    release = threading.Event()

    def wedged_apply(graph):
        if not release.wait(30):  # warmup passes with release pre-set
            raise RuntimeError("never released")
        return sum_apply(graph)

    release.set()
    server = make_server(apply_fn=wedged_apply, max_batch=2,
                         embedding_cache_size=0)
    release.clear()  # wedge every post-warmup batch
    try:
        req = server.submit(1)
        time.sleep(0.1)  # let the engine pick it up and block in the model
        t0 = time.perf_counter()
        server.close(timeout=0.5)
        assert time.perf_counter() - t0 < 5.0
        with pytest.raises(EngineClosed):
            req.result(5)
        # post-close submissions fail fast, too
        with pytest.raises(EngineClosed):
            server.submit(2).result(5)
    finally:
        release.set()  # unwedge the abandoned daemon thread
    server._thread.join(10)
    assert not server._thread.is_alive()


def test_engine_survives_bad_request():
    """A failing batch fails its own requests with ServeError; the engine
    keeps serving everyone else."""
    with make_server() as server:
        bad = server.submit(10 ** 9)  # out-of-range root: sampling raises
        with pytest.raises(ServeError):
            bad.result(10)
        good = server.submit(1).result(10)
        assert np.asarray(good).shape == (4,)
        assert server.stats.failed == 1


def test_queue_full_fails_fast():
    server = make_server(warmup=False, queue_depth=1,
                         embedding_cache_size=0)
    try:
        server._stop.set()  # park the engine so the queue stays full
        server._thread.join(5)
        assert not server._thread.is_alive()
        server._queue.put(object())  # occupy the single slot
        t0 = time.perf_counter()
        req = server.submit(1)
        with pytest.raises(ServeError, match="queue full"):
            req.result(5)
        assert time.perf_counter() - t0 < 5.0
    finally:
        server._queue.get_nowait()
        server.close()


def test_closed_and_open_loop_reports_on_a_live_server():
    with make_server() as server:
        rep = t_loadgen.closed_loop(server, range(10), clients=3,
                                    requests_per_client=5, seed=0,
                                    timeout=30)
        assert rep.mode == "closed_loop"
        assert rep.completed == 15 and rep.errors == 0
        assert len(rep.latencies_ms) == 15
        assert rep.p50_ms <= rep.p99_ms and rep.qps > 0
        assert {"completed", "errors", "qps", "p50_ms", "p99_ms"} \
            <= set(rep.summary())
        rep2 = t_loadgen.open_loop(server, range(10), qps=200.0,
                                   duration_s=0.3, seed=3, timeout=30)
        assert rep2.mode == "open_loop"
        assert rep2.errors == 0 and rep2.completed > 0
        assert rep2.offered_qps == pytest.approx(rep2.completed / 0.3,
                                                 rel=0.01)
        assert rep2.summary()["offered_qps"] > 0
        assert server.steady_state_recompiles == 0


# ---------------------------------------------------------------------------
# the twin vs the JAX example's pieces
# ---------------------------------------------------------------------------

def _jax_example():
    """examples/gnn_serve.py's store, spec, model and parameters."""
    import jax
    from repro.core import HIDDEN_STATE as J_HIDDEN
    from repro.core import mag_schema as j_mag_schema
    from repro.core.models import vanilla_mpnn as j_vanilla_mpnn
    from repro.data import SamplingSpecBuilder as JSpecBuilder
    from repro.data.synthetic import synthetic_mag as j_synthetic_mag
    from repro.nn.layers import Linear as JLinear
    from repro.nn.module import split_params
    from repro.orchestration import (
        RootNodeMulticlassClassification as JRootTask)
    from repro.serve import VersionedGraphStore as JVersionedGraphStore

    dim, n_classes = gnn_serve.DIM, gnn_serve.N_CLASSES
    raw, _ = j_synthetic_mag(n_papers=gnn_serve.PAPERS,
                             n_authors=gnn_serve.PAPERS // 2,
                             n_institutions=20, n_fields=40,
                             n_classes=n_classes, feat_dim=32)
    store = JVersionedGraphStore.wrap(raw)
    b = JSpecBuilder(j_mag_schema())
    seed_op = b.seed("paper")
    seed_op.sample(8, "cites").sample(4, "cites")
    spec = seed_op.build()
    init = JLinear(32, dim)
    gnn = j_vanilla_mpnn({"cites": ("paper", "paper")}, {"paper": dim},
                         message_dim=dim, hidden_dim=dim, num_rounds=2)
    task = JRootTask("paper", n_classes, dim)
    head = task.head()
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"init": split_params(init.init(k1))[0],
              "gnn": split_params(gnn.init(k2))[0],
              "head": split_params(head.init(k3))[0]}

    def apply_fn(p, graph):
        g = graph.replace_features(node_sets={
            "paper": {J_HIDDEN: jax.nn.relu(
                init(p["init"], graph.node_sets["paper"]["feat"]))}})
        return task.predict(p["head"], gnn(p["gnn"], g))

    return store, spec, apply_fn, params


def test_twin_serves_the_jax_example_logits_and_freshness():
    import jax
    from repro.serve import GNNServer as JGNNServer
    store, spec, apply_fn, params = _jax_example()
    server = JGNNServer(store, spec, apply_fn, params,
                        feature_dim=gnn_serve.DIM, max_batch=8,
                        batch_window_ms=1.0)
    try:
        want = server.serve_sync([1, 2, 3], timeout=120)
        v0 = store.version
        server.submit(5).result(60)
        store.add_edges("cites", [5], [gnn_serve.PAPERS - 1])
        server.submit(5).result(60)
        j_invalidations = server.stats.invalidations
    finally:
        server.close()
    assert store.version == v0 + 1 and j_invalidations > 0

    res = gnn_serve.run(device="cpu", open_loop_s=0.3,
                        params=jax.tree_util.tree_map(np.asarray, params))
    assert res.logits.shape == (3, gnn_serve.N_CLASSES)
    np.testing.assert_allclose(res.logits, want, rtol=1e-4, atol=1e-5)
    assert res.versions == (0, 1) and res.stats.invalidations > 0
    assert res.closed.errors == 0 and res.open.errors == 0
    assert res.closed.completed == gnn_serve.CLIENTS \
        * gnn_serve.REQUESTS_PER_CLIENT
    assert res.recompiles == 0 and res.ladder == (1, 2, 4, 8)


def test_twin_main_exits_zero_on_the_cpu(capsys):
    assert gnn_serve.main(["--device", "cpu", "--requests-per-client",
                           "5", "--open-loop-s", "0.2"]) == 0
    out = capsys.readouterr().out
    assert "steady-state recompiles 0" in out and out.endswith("OK\n")


# ---------------------------------------------------------------------------
# the card: one CUDA graph per rung
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_replay_matches_eager_per_rung(cuda_device):
    from repro_torch.data.grouping import merge_and_pad
    from repro_torch.kernels.edge_mpnn.kernel import edge_mpnn
    from repro_torch.nn.layers import init_params

    store, spec = gnn_serve.problem()
    model = init_params(gnn_serve.ServeModel(), 0).to(cuda_device).eval()
    with GNNServer(store, spec, model, device=cuda_device,
                   batch_window_ms=1.0) as server:
        assert server.capture_graphs
        assert sorted(server._graphs) == list(server.ladder.rungs)
        launches = edge_mpnn.launches
        for rung in server.ladder.rungs:
            merged = merge_and_pad(
                [server._subgraphs.get(r) for r in range(10, 10 + rung)],
                server.ladder.sizes[rung])
            got = server.run_batch(merged)
            assert edge_mpnn.launches == launches  # replays count nothing
            want = server.run_eager(merged)
            launches = edge_mpnn.launches
            assert got.shape == want.shape == (rung + 1,
                                               gnn_serve.N_CLASSES)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        out_one = server.serve_sync([1], timeout=60)
        out = server.serve_sync(list(range(40, 47)), timeout=60)
        assert out.shape == (7, gnn_serve.N_CLASSES)
        assert np.isfinite(out).all()
        assert server.steady_state_recompiles == 0
        with pytest.raises(ValueError, match="differs from the captured"):
            server.run_batch(merge_and_pad(
                [server._subgraphs.get(1)],
                server.ladder.sizes[2]).replace_features(node_sets={
                    "paper": {"feat": np.zeros((1, 1), np.float32)}}))

    # without warmup a rung is captured when first served: a recompile
    with GNNServer(store, spec, model, device=cuda_device, warmup=False,
                   max_batch=2, embedding_cache_size=0) as cold:
        got = cold.serve_sync([1], timeout=60)
        assert sorted(cold._graphs) == [1]
        assert cold.steady_state_recompiles == 1
    np.testing.assert_allclose(got, out_one, rtol=1e-5, atol=1e-5)

    class HostSync(torch.nn.Module):
        def forward(self, graph):
            out = model(graph)
            return out * out.sum().item()  # a host sync: capture aborts

    with pytest.raises(RuntimeError):
        GNNServer(store, spec, HostSync(), device=cuda_device,
                  max_batch=1)
