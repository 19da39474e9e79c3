"""Load generation + latency accounting for the GNN serving path — a
copy of `repro.serve.loadgen`, numpy and threading only (it imports
neither torch nor anything of the port), so two runs with one seed offer
the reference's request sequence; held to the original by
tests/test_torch_serve_loop.py.

Two canonical load shapes (Gray's classic distinction, and what serving
benchmarks actually gate):

  * **closed loop** — k client threads, each with one outstanding request
    at a time: measures best-case latency under a fixed concurrency and
    the throughput that concurrency sustains.  Offered load adapts to the
    server (a slow server is offered less), so closed-loop p99 understates
    overload behaviour;
  * **open loop** — requests arrive on a fixed schedule (deterministic,
    seeded exponential inter-arrivals ~ Poisson) regardless of
    completions: measures the latency distribution at a target QPS,
    including queueing delay — the "heavy traffic from millions of users"
    regime where arrival does not wait for service.

Both report p50/p99 latency and sustained QPS from per-request
(`submitted_at`, `done_at`) stamps recorded by the server, so an
embedding-cache hit (fulfilled synchronously in `submit`) and a batched
model run are measured identically.

Determinism: root choice and inter-arrival draws come from
`np.random.default_rng(seed)` streams — two runs offer the identical
request sequence; only service times differ.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LoadReport:
    """One load-generation run, reduced to the gate-able numbers."""

    mode: str                   # "closed_loop" | "open_loop"
    completed: int
    errors: int
    duration_s: float
    latencies_ms: tuple         # per completed request, submission order
    offered_qps: Optional[float] = None   # open loop only

    @property
    def qps(self) -> float:
        """Sustained throughput: completions per wall-clock second."""
        return self.completed / self.duration_s if self.duration_s else 0.0

    def percentile_ms(self, q: float) -> float:
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_ms), q))

    @property
    def p50_ms(self) -> float:
        return self.percentile_ms(50.0)

    @property
    def p99_ms(self) -> float:
        return self.percentile_ms(99.0)

    def summary(self) -> dict:
        """JSON-ready summary (the BENCH_serve.json building block)."""
        out = {
            "completed": self.completed,
            "errors": self.errors,
            "duration_s": round(self.duration_s, 4),
            "qps": round(self.qps, 2),
            "p50_ms": round(self.p50_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
        }
        if self.offered_qps is not None:
            out["offered_qps"] = round(self.offered_qps, 2)
        return out


def _harvest(pending, timeout: float) -> tuple:
    """(latencies_ms in submission order, error count) for a request
    list; a request that cannot complete within `timeout` counts as an
    error instead of hanging the generator."""
    latencies, errors = [], 0
    for req in pending:
        try:
            req.result(timeout)
            latencies.append(req.latency_s * 1e3)
        except Exception:  # noqa: BLE001 — the report must count failures of any kind, not propagate mid-harvest
            errors += 1
    return latencies, errors


def closed_loop(server, roots: Sequence[int], *, clients: int = 4,
                requests_per_client: int = 50, seed: int = 0,
                timeout: float = 30.0) -> LoadReport:
    """k synchronous clients, one outstanding request each.  Each client
    draws its own deterministic root sequence from fold-in streams of
    `seed`, so the offered request multiset is run-invariant."""
    roots = np.asarray(roots)
    results: list[list] = [[] for _ in range(clients)]

    def client(idx: int) -> None:
        rng = np.random.default_rng((seed, idx))
        for _ in range(requests_per_client):
            root = int(roots[rng.integers(len(roots))])
            req = server.submit(root)
            try:
                req.result(timeout)
            except Exception:  # noqa: BLE001 — a failed request is a data point for the report, not a generator crash
                pass
            results[idx].append(req)

    threads: list[threading.Thread] = []
    for i in range(clients):
        threads.append(threading.Thread(target=client, args=(i,),
                                        name=f"loadgen-client-{i}",
                                        daemon=True))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout * requests_per_client)
    duration = time.perf_counter() - t0
    pending = [r for client_reqs in results for r in client_reqs]
    latencies, errors = _harvest(pending, timeout=0.001)
    return LoadReport(mode="closed_loop", completed=len(latencies),
                      errors=errors, duration_s=duration,
                      latencies_ms=tuple(latencies))


def open_loop(server, roots: Sequence[int], *, qps: float,
              duration_s: float = 2.0, seed: int = 0,
              timeout: float = 30.0) -> LoadReport:
    """Fixed-rate arrivals: a submitter thread fires requests on a
    pre-drawn exponential schedule (mean rate `qps`) for `duration_s`,
    never waiting for completions; the report then harvests every
    request.  Sustained QPS = completions / (last completion - start) —
    a server that cannot keep up shows it as queueing-inflated p99 and a
    sustained rate below the offered one."""
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    rng = np.random.default_rng(seed)
    arrivals = []
    t = 0.0
    while t < duration_s:
        arrivals.append(t)
        t += float(rng.exponential(1.0 / qps))
    roots = np.asarray(roots)
    chosen = roots[rng.integers(len(roots), size=len(arrivals))]
    pending: list = []

    def submitter() -> None:
        start = time.perf_counter()
        for at, root in zip(arrivals, chosen):
            delay = at - (time.perf_counter() - start)
            if delay > 0:
                time.sleep(delay)
            pending.append(server.submit(int(root)))

    thread = threading.Thread(target=submitter, name="loadgen-open-loop",
                              daemon=True)
    t0 = time.perf_counter()
    thread.start()
    thread.join(duration_s + timeout)
    latencies, errors = _harvest(pending, timeout)
    done_at = [r.done_at for r in pending if r.done_at is not None]
    span = (max(done_at) - t0) if done_at else duration_s
    return LoadReport(mode="open_loop", completed=len(latencies),
                      errors=errors, duration_s=max(span, 1e-9),
                      latencies_ms=tuple(latencies),
                      offered_qps=len(arrivals) / duration_s)
