"""The port's training slice against the JAX package, on the CPU.

* `AdamW`, `warmup_cosine`, `constant_lr` and `clip_by_global_norm`
  against the reference's over a few updates (fp32; rtol 1e-6 on the
  schedule, 1e-5 on parameters and moments: pow and sqrt round in
  another library).
* The slice as a whole: the §8 pipeline at a small size (2 rounds, 16
  wide, 96 papers) — `BatcherProvider` batches sorted by target, the
  root-node task, AdamW + warmup-cosine — trained by the port's
  `Trainer` from the JAX `Trainer._init_params` parameters (loaded with
  `load_jax_params`) and by the JAX `make_graph_train_step` loop over the
  same stream, JAX kernels off (the reference both ways).  Per-step
  losses, final parameters and `evaluate`'s metrics must agree within
  rtol 1e-4 / atol 1e-5 (fp32 sums in another order, through 6 Adam
  steps).
* The Trainer's contract: CUDA unless asked, a world that does not
  match ``num_devices`` raises, checkpointing constructs, the layout hint is held on the loop's
  thread and not on a server's engine thread, and `runner.run` is a shim
  over `fit`.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph_tensor import HIDDEN_STATE as J_HIDDEN
from repro.core.models import vanilla_mpnn as j_vanilla_mpnn
from repro.core.schema import mag_schema as j_mag_schema
from repro.data import sampling as j_sampling
from repro.data.batching import find_size_constraints as j_find_sizes
from repro.data.synthetic import synthetic_mag as j_synthetic_mag
from repro.kernels import dispatch as j_dispatch
from repro.nn.layers import Embedding as JEmbedding, Linear as JLinear
from repro.nn.module import Module as JModule
from repro.orchestration import evaluation as j_evaluation
from repro.orchestration.providers import BatcherProvider as JProvider
from repro.orchestration.tasks import (
    RootNodeMulticlassClassification as JRootTask)
from repro.orchestration.trainer import Trainer as JTrainer
from repro.train import optimizer as j_opt
from repro.train.train_loop import (make_graph_eval_step as j_eval_step,
                                    make_graph_train_step as j_train_step)

from repro_torch.core.graph_tensor import HIDDEN_STATE
from repro_torch.core.models import vanilla_mpnn as t_vanilla_mpnn
from repro_torch.core.schema import mag_schema as t_mag_schema
from repro_torch.data import sampling as t_sampling
from repro_torch.data.batching import find_size_constraints as t_find_sizes
from repro_torch.data.synthetic import synthetic_mag as t_synthetic_mag
from repro_torch.kernels import registry
from repro_torch.nn.layers import Embedding, Linear
from repro_torch.orchestration import evaluation as t_evaluation
from repro_torch.orchestration import runner as t_runner
from repro_torch.orchestration.providers import (BatcherProvider,
                                                 IteratorProvider)
from repro_torch.orchestration.tasks import RootNodeMulticlassClassification
from repro_torch.orchestration.trainer import Trainer
from repro_torch.train import optimizer as t_opt

FEAT, DIM, N_CLASSES, ROUNDS, VOCAB = 8, 16, 4, 2, 64
STORE_KW = dict(n_papers=96, n_authors=48, n_institutions=6, n_fields=12,
                n_classes=N_CLASSES, feat_dim=FEAT)
BATCH, N_TRAIN, N_EVAL = 8, 48, 16
LR, WARMUP, TOTAL = 3e-3, 2, 20


def tree(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {f"p{i}": (scale * rng.standard_normal((3, i + 1)))
            .astype(np.float32) for i in range(n)}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_schedules_match_reference():
    steps = np.arange(0, 130, dtype=np.int32)
    for jf, tf in ((j_opt.warmup_cosine(3e-3, 50, 120),
                    t_opt.warmup_cosine(3e-3, 50, 120)),
                   (j_opt.warmup_cosine(1e-2, 0, 10, final_frac=0.3),
                    t_opt.warmup_cosine(1e-2, 0, 10, final_frac=0.3)),
                   (j_opt.constant_lr(5e-4), t_opt.constant_lr(5e-4))):
        want = np.asarray([jf(jnp.asarray(s)) for s in steps])
        got = np.asarray([tf(torch.tensor(s)).item() for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    # the decay ends at final_frac = 0.1 of the peak
    assert t_opt.warmup_cosine(1.0, 2, 10)(torch.tensor(10)).item() == \
        pytest.approx(0.1)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_matches_reference(scale):
    """Below the limit nothing changes; above it every leaf scales by
    1 / (norm + 1e-9)."""
    grads = tree(4, 1, scale)
    want, want_norm = j_opt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in grads.items()}, 1.0)
    got, norm = t_opt.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in grads.items()}, 1.0)
    np.testing.assert_allclose(norm.item(), float(want_norm), rtol=1e-6)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("weight_decay", [0.1, 1e-5])
def test_adamw_matches_reference_over_updates(weight_decay):
    """Five updates with large gradients (so the clip acts), a
    warmup-cosine lr read at step + 1, and the given decay."""
    params = tree(3, 2)
    jopt = j_opt.AdamW(learning_rate=j_opt.warmup_cosine(1e-2, 2, 10),
                       weight_decay=weight_decay)
    topt = t_opt.AdamW(learning_rate=t_opt.warmup_cosine(1e-2, 2, 10),
                       weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(5):
        grads = tree(3, 10 + i, scale=3.0)
        jp, js, jinfo = jopt.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        tp, ts, tinfo = topt.update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, ts, tp)
        np.testing.assert_allclose(tinfo["learning_rate"].item(),
                                   float(jinfo["learning_rate"]), rtol=1e-6)
        np.testing.assert_allclose(tinfo["grad_norm"].item(),
                                   float(jinfo["grad_norm"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5
    for k in params:
        for got, want in ((tp[k], jp[k]), (ts.m[k], js.m[k]),
                          (ts.v[k], js.v[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-7)


def test_adamw_is_not_torch_adamw():
    """The reference's AdamW, not torch.optim.AdamW: b2 0.95, clipping
    built in, decay inside the lr-scaled delta, and the Trainer passes
    weight_decay 1e-5 (the class default is 0.1)."""
    opt = t_opt.AdamW()
    ref = j_opt.AdamW()
    assert (opt.b1, opt.b2, opt.eps, opt.weight_decay, opt.max_grad_norm) \
        == (ref.b1, ref.b2, ref.eps, ref.weight_decay, ref.max_grad_norm) \
        == (0.9, 0.95, 1e-8, 0.1, 1.0)
    assert Trainer().weight_decay == JTrainer().weight_decay == 1e-5
    assert Trainer().warmup_steps == JTrainer().warmup_steps == 50
    # three steps whose gradient norms differ: the built-in clip changes
    # their relative weight in the moments, which torch's AdamW does not
    params = tree(2, 3)
    grads = [tree(2, 4 + i, scale=s)
             for i, s in enumerate((5.0, 0.1, 20.0))]
    ours = t_opt.AdamW(learning_rate=0.1, weight_decay=0.1)
    tp = {k: torch.from_numpy(v).clone() for k, v in params.items()}
    state = ours.init(tp)
    leaves = [torch.nn.Parameter(torch.from_numpy(v).clone())
              for v in params.values()]
    torch_opt = torch.optim.AdamW(leaves, lr=0.1, betas=(0.9, 0.95),
                                  eps=1e-8, weight_decay=0.1)
    for g in grads:
        tp, state, _ = ours.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, state, tp)
        for leaf, v in zip(leaves, g.values()):
            leaf.grad = torch.from_numpy(v)
        torch_opt.step()
    assert max((a - b).abs().max().item()
               for a, b in zip(tp.values(), leaves)) > 1e-2


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def section8_spec(module, schema):
    """The §8 sampling spec (examples/ogbn_mag_train.py) at fanout 2."""
    b = module.SamplingSpecBuilder(schema)
    seed_op = b.seed("paper")
    cited = seed_op.sample(4, "cites")
    authors = cited.join([seed_op]).sample(2, "written")
    author_papers = authors.sample(2, "writes")
    authors.sample(2, "affiliated_with")
    author_papers.join([seed_op, cited]).sample(2, "has_topic")
    return seed_op.build()


class JInitStates(JModule):
    """Initial states as the §8 example builds them (reference side)."""

    def __init__(self):
        self.paper = JLinear(FEAT, DIM)
        self.tables = {n: JEmbedding(VOCAB, DIM)
                       for n in ("author", "institution", "field_of_study")}

    def init(self, key):
        ks = jax.random.split(key, 4)
        p = {"paper": self.paper.init(ks[0])}
        for i, (n, t) in enumerate(sorted(self.tables.items())):
            p[n] = t.init(ks[i + 1])
        return p

    def __call__(self, params, graph):
        ns = {"paper": {J_HIDDEN: jax.nn.relu(self.paper(
            params["paper"], graph.node_sets["paper"]["feat"]))}}
        for n, t in self.tables.items():
            ids = graph.node_sets[n]["id"] % VOCAB
            ns[n] = {J_HIDDEN: t(params[n], ids, dtype=jnp.float32)}
        return graph.replace_features(node_sets=ns)


class TInitStates(torch.nn.Module):
    """The port's twin of JInitStates (same parameter names)."""

    def __init__(self):
        super().__init__()
        self.paper = Linear(FEAT, DIM)
        self.author = Embedding(VOCAB, DIM)
        self.institution = Embedding(VOCAB, DIM)
        self.field_of_study = Embedding(VOCAB, DIM)

    def forward(self, graph):
        ns = {"paper": {HIDDEN_STATE: torch.relu(self.paper(
            graph.node_sets["paper"]["feat"]))}}
        for n in ("author", "institution", "field_of_study"):
            ids = graph.node_sets[n]["id"] % VOCAB
            ns[n] = {HIDDEN_STATE: getattr(self, n)(ids,
                                                    dtype=torch.float32)}
        return graph.replace_features(node_sets=ns)


def t_model_fn(reduce_type="sum"):
    schema = t_mag_schema()
    edges = {k: (v.source, v.target) for k, v in schema.edge_sets.items()}
    return TInitStates(), t_vanilla_mpnn(
        edges, {n: DIM for n in schema.node_sets}, message_dim=DIM,
        hidden_dim=DIM, num_rounds=ROUNDS, reduce_type=reduce_type)


@pytest.fixture(scope="module")
def data():
    """The same sampled subgraphs and size constraints in both packages
    (the host copies are held equal in test_torch_host_parity.py)."""
    jstore, _ = j_synthetic_mag(**STORE_KW)
    tstore, _ = t_synthetic_mag(**STORE_KW)
    jspec = section8_spec(j_sampling, jstore.schema)
    tspec = section8_spec(t_sampling, tstore.schema)
    roots = range(N_TRAIN + N_EVAL)
    jg = [j_sampling.sample_subgraph(jstore, jspec, r,
                                     j_sampling.seed_rng(0, r))
          for r in roots]
    tg = [t_sampling.sample_subgraph(tstore, tspec, r,
                                     t_sampling.seed_rng(0, r))
          for r in roots]
    sizes = t_find_sizes(tg, BATCH)
    assert dataclasses.astuple(sizes) == \
        dataclasses.astuple(j_find_sizes(jg, BATCH))
    return jg, tg, sizes


@pytest.fixture(scope="module")
def jax_run(data):
    """The reference: JAX Trainer parameters, its make_graph_train_step
    loop over a BatcherProvider, then `evaluate` on the held-out roots."""
    assert not j_dispatch.enabled()  # the jnp reference, no kernels
    jg, _, sizes = data
    schema = j_mag_schema()
    edges = {k: (v.source, v.target) for k, v in schema.edge_sets.items()}
    init = JInitStates()
    gnn = j_vanilla_mpnn(edges, {n: DIM for n in schema.node_sets},
                         message_dim=DIM, hidden_dim=DIM, num_rounds=ROUNDS)
    task = JRootTask("paper", N_CLASSES, DIM)
    trainer = JTrainer(learning_rate=LR, warmup_steps=WARMUP,
                       total_steps=TOTAL)
    params = trainer._init_params(init, gnn, task.head())
    initial = jax.tree_util.tree_map(np.asarray, params)
    opt = j_opt.AdamW(learning_rate=j_opt.warmup_cosine(LR, WARMUP, TOTAL),
                      weight_decay=trainer.weight_decay)
    opt_state = opt.init(params)

    def loss_fn(p, graph, labels):
        return task.loss_from_graph(p["head"], gnn(p["gnn"], init(
            p["init"], graph)), labels)

    def metric_fn(p, graph, labels):
        pairs = task.metrics(p["head"], gnn(p["gnn"], init(p["init"],
                                                           graph)), labels)
        return tuple(x for k in task.metric_names() for x in pairs[k])

    step_fn = j_train_step(loss_fn, opt)
    provider = JProvider(jg[:N_TRAIN], BATCH, sizes)
    losses = []
    with j_dispatch.layout(sorted_by_target=True):
        for step, graph in enumerate(provider.epoch(0)):
            labels = task.labels(graph, epoch=0, step=step)
            params, opt_state, loss = step_fn(
                params, opt_state, jax.tree_util.tree_map(jnp.asarray,
                                                          graph),
                jnp.asarray(labels))
            losses.append(float(loss))
        eval_fn = j_eval_step(metric_fn)
        metrics = j_evaluation.evaluate(
            JProvider(jg[N_TRAIN:], BATCH, sizes), task,
            lambda g, lab: eval_fn(params, g, lab),
            lambda g, lab: (jax.tree_util.tree_map(jnp.asarray, g),
                            jnp.asarray(lab)),
            metric_keys=task.metric_names())
    return initial, losses, jax.tree_util.tree_map(np.asarray, params), \
        metrics


def flat(tree_, prefix=""):
    if isinstance(tree_, dict):
        out = {}
        for k, v in tree_.items():
            out.update(flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    if isinstance(tree_, (list, tuple)):
        return flat(dict(enumerate(tree_)), prefix)
    return {prefix: np.asarray(tree_)}


def test_training_run_matches_jax(data, jax_run):
    _, tg, sizes = data
    initial, want_losses, want_params, want_metrics = jax_run
    task = RootNodeMulticlassClassification("paper", N_CLASSES, DIM)
    trainer = Trainer(learning_rate=LR, warmup_steps=WARMUP,
                      total_steps=TOTAL, device="cpu", log_every=10 ** 6)
    result = trainer.fit(
        t_model_fn, task, BatcherProvider(tg[:N_TRAIN], BATCH, sizes),
        eval_provider=BatcherProvider(tg[N_TRAIN:], BATCH, sizes),
        params=initial)
    losses = result.metrics["train_losses"]
    assert result.step == len(losses) == len(want_losses) == 6
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4, atol=1e-5)
    got = {k: v.numpy() for k, v in result.metrics["params"].items()}
    want = flat(want_params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    start = flat(initial)
    assert max(np.abs(got[k] - start[k]).max() for k in got) > 1e-3
    assert sorted(result.metrics["eval"]) == ["accuracy", "loss"]
    for k, v in want_metrics.items():
        np.testing.assert_allclose(result.metrics["eval"][k], v,
                                   rtol=1e-4, atol=1e-5)
    assert len(result.metrics["step_seconds"]) == 6


def test_runner_run_is_a_shim_over_fit(data, jax_run):
    """runner.run(train_batches=...) trains the trajectory Trainer.fit
    trains with the reference's runner defaults (warmup 50), here with
    double-buffered placement (device_prefetch); ``sampler="service"``
    without a fleet and a label_fn raises, as in the reference."""
    _, tg, sizes = data
    initial = jax_run[0]
    task = RootNodeMulticlassClassification("paper", N_CLASSES, DIM)
    train = BatcherProvider(tg[:N_TRAIN], BATCH, sizes)
    res = t_runner.run(train_batches=train.epoch, model_fn=t_model_fn,
                       task=task, learning_rate=LR, total_steps=TOTAL,
                       device="cpu", params=initial, log_every=10 ** 6,
                       double_buffer=True,
                       eval_batches=lambda: BatcherProvider(
                           tg[N_TRAIN:], BATCH, sizes).epoch(0))
    want = Trainer(learning_rate=LR, total_steps=TOTAL, device="cpu",
                   log_every=10 ** 6).fit(t_model_fn, task, train,
                                          params=initial)
    np.testing.assert_allclose(res.metrics["train_losses"],
                               want.metrics["train_losses"], rtol=1e-6)
    assert 0.0 <= res.metrics["eval_accuracy"] <= 1.0
    with pytest.raises(ValueError, match="needs service="):
        t_runner.run(model_fn=t_model_fn, task=task, sampler="service")


def test_mean_variant_trains_from_a_seeded_draw(data):
    """The mean-pooling model (the generic conv path, whose pooling is
    segment_pool_runs on the card) trains from `init_params(model,
    seed)`, and the draw is a pure function of the seed."""
    _, tg, sizes = data
    task = RootNodeMulticlassClassification("paper", N_CLASSES, DIM)
    runs = [Trainer(learning_rate=LR, warmup_steps=WARMUP,
                    total_steps=TOTAL, device="cpu", max_steps=3,
                    log_every=10 ** 6).fit(
        lambda: t_model_fn("mean"), task,
        BatcherProvider(tg[:N_TRAIN], BATCH, sizes))
        for _ in range(2)]
    assert runs[0].step == 3
    np.testing.assert_allclose(runs[0].metrics["train_losses"],
                               runs[1].metrics["train_losses"], rtol=1e-6)
    assert all(np.isfinite(runs[0].metrics["train_losses"]))


def test_trainer_defaults_to_cuda_and_leaves_out_what_is_not_ported(
        monkeypatch, data):
    _, tg, sizes = data
    task = RootNodeMulticlassClassification("paper", N_CLASSES, DIM)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer().fit(t_model_fn, task,
                      BatcherProvider(tg[:N_TRAIN], BATCH, sizes))
    # checkpointing is ported: both construct (tests/test_torch_checkpoint.py
    # drives them)
    assert Trainer(ckpt_dir="ckpt").ckpt_dir == "ckpt"
    assert Trainer(resume=True).resume
    # the mesh is ported (tests/test_torch_partition.py,
    # test_torch_mesh.py): a world that does not match num_devices raises
    # the reference's message at fit, and so does a model axis without it
    batches = BatcherProvider(tg[:N_TRAIN], BATCH, sizes)
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        Trainer(num_devices=2, device="cpu").fit(t_model_fn, task, batches)
    with pytest.raises(ValueError, match="needs num_devices"):
        Trainer(model_parallel=2, device="cpu").fit(t_model_fn, task,
                                                    batches)
    with pytest.raises(ValueError, match="eval_at"):
        Trainer(eval_at="sometimes")


def test_layout_is_held_on_the_loop_thread_only(data):
    """The Trainer's loop thread holds the layout bit for every step and
    eval step (the registry reads it per call); a GNNServer's engine
    thread never does, so serving stays on the unsorted kernels even
    while a caller holds the hint."""
    from repro_torch.serve.gnn import GNNServer
    _, tg, sizes = data
    seen = []

    class Spy(RootNodeMulticlassClassification):
        def predict(self, head, graph):
            seen.append((threading.current_thread().name,
                         registry.layout_sorted_by_target()))
            return super().predict(head, graph)

    task = Spy("paper", N_CLASSES, DIM)
    Trainer(device="cpu", max_steps=2, log_every=10 ** 6).fit(
        t_model_fn, task, BatcherProvider(tg[:N_TRAIN], BATCH, sizes),
        eval_provider=BatcherProvider(tg[N_TRAIN:], BATCH, sizes))
    main = threading.current_thread().name
    assert seen == [(main, True)] * (2 + N_EVAL // BATCH)
    seen.clear()
    Trainer(device="cpu", max_steps=1, log_every=10 ** 6,
            edges_sorted_by_target=False).fit(
        t_model_fn, task, BatcherProvider(tg[:N_TRAIN], BATCH, sizes))
    assert seen == [(main, False)]

    init, gnn = t_model_fn()
    head = task.head()

    class Served(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.init, self.gnn, self.head = init, gnn, head

        def forward(self, graph):
            return task.predict(self.head, self.gnn(self.init(graph)))

    store, _ = t_synthetic_mag(**STORE_KW)
    seen.clear()
    with registry.layout(sorted_by_target=True):
        server = GNNServer(store, section8_spec(t_sampling, store.schema),
                           Served(), device="cpu", max_batch=2,
                           batch_window_ms=1.0)
        try:
            server.serve_sync([1, 2], timeout=60)
        finally:
            server.close()
    assert seen and all(not sorted_ for _, sorted_ in seen)
    assert any(name == "gnn-serve-engine" for name, _ in seen)


def test_iterator_provider_and_labels_from_pairs(data):
    """A provider that yields (graph, labels) pairs skips Task.labels;
    IteratorProvider skips by consuming and needs num_steps declared."""
    _, tg, sizes = data
    task = RootNodeMulticlassClassification("paper", N_CLASSES, DIM)
    batches = list(BatcherProvider(tg[:N_TRAIN], BATCH, sizes).epoch(0))
    pairs = [(g, task.labels(g)) for g in batches]
    prov = IteratorProvider(lambda e: iter(pairs))
    with pytest.raises(ValueError, match="num_steps"):
        prov.num_steps
    assert len(list(prov.epoch(0, start_step=4))) == len(pairs) - 4
    res = Trainer(device="cpu", max_steps=2, log_every=10 ** 6).fit(
        t_model_fn, task, prov)
    assert res.step == 2 and np.isfinite(res.train_loss)


def test_chip_parity_runs_keep_fp32_products_in_full_fp32():
    """TF32 would round fp32 products to ~3 decimal digits on the card:
    chip_smoke.py (and the cuda tests' fixture) turn it off for every
    parity run."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_probe", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        smoke.full_fp32(torch)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def test_evaluation_helpers_match_reference():
    for stopper in (lambda m: m.EarlyStopping(monitor="loss", patience=2,
                                              min_delta=0.05),
                    lambda m: m.EarlyStopping(monitor="accuracy",
                                              patience=1, mode="max")):
        j, t = stopper(j_evaluation), stopper(t_evaluation)
        for step, value in enumerate([1.0, 0.97, 0.9, 0.95, 0.96, 0.99]):
            assert j.update(value, step=step) == t.update(value, step=step)
            assert (j.best, j.best_step, j.bad_evals, j.should_stop) == \
                (t.best, t.best_step, t.bad_evals, t.should_stop)
    batches = [{"a": (3, 4), "b": (1.5, 2)}, {"a": (1, 4), "b": (0, 0)}]
    jt = tt = None
    for pairs in batches:
        jt = j_evaluation.merge_metric_sums(jt, pairs)
        tt = t_evaluation.merge_metric_sums(tt, pairs)
    assert jt == tt
    assert j_evaluation.finalize_metrics(jt) == \
        t_evaluation.finalize_metrics(tt) == {"a": 0.5, "b": 0.75}
    assert t_evaluation.finalize_metrics(None) == {}
