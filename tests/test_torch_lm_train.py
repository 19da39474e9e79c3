"""The pieces of the port's LM training against the JAX package, on the
CPU (the arch-by-arch train steps are in `test_torch_lm_train_arch.py`
and `test_torch_lm_train_families.py`).

* `softmax_cross_entropy` and `chunked_cross_entropy`: value and input
  gradient against the reference, with and without a mask, at S 48 with
  seq_chunk 32 (the divisor fallback takes chunks of 24) and in one
  chunk.  rtol 1e-5.
* `AdamW.update_` (in place, a leaf above a lowered
  CHUNKED_UPDATE_THRESHOLD in row slices) against the reference's
  `AdamW.update` on identical numpy gradients over three updates, the
  clip acting: atol 1e-7 (parameters at LM init scale); and against the
  port's own functional `update`, bit for bit, writing into the very
  tensors it was given.
* `Adafactor` against the reference on the reference's stacked tree of
  two smoke models (per-layer norm scales stacked [L, d] and factored,
  the MoE expert stacks [L, E, ...], `rms_u` per leaf, and per layer
  slice above a lowered threshold): new parameters and both moments,
  three updates, rtol 1e-6 (with ``group=`` and ``shard_dims=`` on 2
  gloo ranks in `test_torch_lm_train_zero.py`, whose spawned ranks
  import no JAX); `Adafactor.update_` against its `update` bit for bit,
  writing into the tensors it was given and stacking no group of 2-D or
  larger leaves.
* `make_optimizer`: kinds, the schedule, an unknown kind.
* `ErrorFeedbackCompressor` against the reference over 5 steps: int8
  codes, scales, residuals and compressed gradients exactly (a code
  that lands on a rounding tie would be counted and printed; none
  does); `compress_int8_stateless` exactly; `bind` carries the
  residual.
* `maybe_remat`: "layer" and "dots" against "none", gradients equal
  within rtol 1e-6 (the recomputed backward may sum in another order on
  the CPU; on the card `[lm-train]` (b) finds them bit for bit), every
  family's layer loop (each block recomputed in the backward, run once
  under no_grad), and the ops the "dots" policy saves.
* A bf16-parameter smoke model's ``.grad`` dtypes: bf16, the effect of
  the reference's gradient-dtype barrier without one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as j_comp
from repro.train import optimizer as j_opt
from repro.train import train_loop as j_loop

from repro_torch.distributed import compression as t_comp
from repro_torch.models import registry
from repro_torch.nn import layers as t_layers
from repro_torch.nn import transformer as t_transformer
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_loop as t_loop
from test_torch_lm import lm_pair

RTOL = 1e-5


def normal(shape, seed, scale=1.0):
    return np.asarray(scale * np.random.default_rng(seed)
                      .standard_normal(shape), np.float32)


def flat(tree, prefix=""):
    """{dotted path: numpy leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------

def _mask(shape, seed):
    return (np.random.default_rng(seed).random(shape) < 0.7) \
        .astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_reference(masked):
    logits = normal((2, 7, 33), 1, 3.0)
    labels = np.random.default_rng(2).integers(0, 33, (2, 7)) \
        .astype(np.int32)
    mask = _mask((2, 7), 3) if masked else None

    def j_fn(lg):
        return j_loop.softmax_cross_entropy(
            lg, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask))

    j_loss, j_den = j_fn(jnp.asarray(logits))
    j_grad = jax.grad(lambda lg: j_fn(lg)[0])(jnp.asarray(logits))
    t_logits = torch.from_numpy(logits).requires_grad_()
    t_loss, t_den = t_loop.softmax_cross_entropy(
        t_logits, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=RTOL)
    assert t_den.item() == float(j_den)
    np.testing.assert_allclose(t_logits.grad.numpy(), np.asarray(j_grad),
                               rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seq,chunk", [(48, 32), (48, 64), (48, 16)])
def test_chunked_cross_entropy_matches_reference(seq, chunk, masked):
    """S 48, chunk 32: the divisor fallback gives 2 chunks of 24; chunk
    64 is one chunk; 16 three.  Value and the gradient of x."""
    d, v = 16, 40
    x = normal((2, seq, d), 4)
    w = normal((d, v), 5, 0.5)
    labels = np.random.default_rng(6).integers(0, v, (2, seq)) \
        .astype(np.int32)
    mask = _mask((2, seq), 7) if masked else None

    def j_head(params, xc):
        return (xc @ params).astype(jnp.float32)

    def j_fn(xx):
        return j_loop.chunked_cross_entropy(
            j_head, jnp.asarray(w), xx, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), seq_chunk=chunk)

    j_loss, j_den = j_fn(jnp.asarray(x))
    j_grad = jax.grad(lambda xx: j_fn(xx)[0])(jnp.asarray(x))
    tw = torch.from_numpy(w)
    calls = []

    def t_head(xc):
        calls.append(tuple(xc.shape))
        return (xc @ tw).to(torch.float32)

    tx = torch.from_numpy(x).requires_grad_()
    t_loss, t_den = t_loop.chunked_cross_entropy(
        t_head, tx, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), seq_chunk=chunk)
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=RTOL)
    assert t_den.item() == float(j_den)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_grad),
                               rtol=RTOL, atol=1e-8)
    c = {32: 24, 64: 48, 16: 16}[chunk]
    n = seq // c
    # forward once a chunk, and once more a chunk in the backward (the
    # checkpointed body) when there is more than one chunk
    assert calls == [(2, c, d)] * (n if n == 1 else 2 * n)


# ---------------------------------------------------------------------------
# AdamW: the in-place, sliced update
# ---------------------------------------------------------------------------

SHAPES = {"big": (40, 16), "w": (8, 6), "b": (6,), "s": ()}


@pytest.fixture
def small_slices(monkeypatch):
    """A 640-element leaf above the threshold, in slices of 3 rows."""
    monkeypatch.setattr(t_opt, "CHUNKED_UPDATE_THRESHOLD", 100)
    monkeypatch.setattr(t_opt, "UPDATE_SLICE", 48)
    monkeypatch.setattr(j_opt, "CHUNKED_UPDATE_THRESHOLD", 100)


def test_slices_cover_rows_in_order(small_slices):
    big = torch.arange(640.0).reshape(40, 16)
    parts = list(t_opt._slices(big, big + 1))
    assert [p[0].shape[0] for p in parts] == [3] * 13 + [1]
    assert torch.equal(torch.cat([p[0] for p in parts]), big)
    assert all(p[0].data_ptr() == big[3 * i].data_ptr()
               for i, p in enumerate(parts))  # views, not copies
    small = torch.ones(8, 6)
    assert [p[0] is small for p in t_opt._slices(small)] == [True]


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_in_place_matches_reference(small_slices, moment_dtype):
    """Parameters at the scale of the LMs' initialization (0.1; lecun
    normal at d 128 is 0.088), where atol 1e-7 is about an fp32 ulp: the
    reference's pow and sqrt round in another library."""
    params = {k: normal(s, i, 0.1) for i, (k, s) in enumerate(SHAPES.items())}
    jopt = j_opt.AdamW(learning_rate=j_opt.warmup_cosine(1e-2, 2, 10),
                       moment_dtype=getattr(jnp, moment_dtype))
    topt = t_opt.AdamW(learning_rate=t_opt.warmup_cosine(1e-2, 2, 10),
                       moment_dtype=getattr(torch, moment_dtype))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    fp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts, fs = jopt.init(jp), topt.init(tp), topt.init(fp)
    ptrs = {k: t.data_ptr() for k, t in tp.items()}
    mptrs = {k: t.data_ptr() for k, t in ts.m.items()}
    for i in range(3):
        grads = {k: normal(s, 20 + 5 * i + j, 3.0)
                 for j, (k, s) in enumerate(SHAPES.items())}
        jp, js, jinfo = jopt.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        tg = {k: torch.from_numpy(v) for k, v in grads.items()}
        out, ts, tinfo = topt.update_(tg, ts, tp)
        assert out is tp
        fp, fs, _ = topt.update(tg, fs, fp)
        assert float(jinfo["grad_norm"]) > 1.0  # the clip acts
        np.testing.assert_allclose(tinfo["grad_norm"].item(),
                                   float(jinfo["grad_norm"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for k in SHAPES:
        assert tp[k].data_ptr() == ptrs[k] and ts.m[k].data_ptr() == mptrs[k]
        for got, plain, want in ((tp[k], fp[k], jp[k]),
                                 (ts.m[k], fs.m[k], js.m[k]),
                                 (ts.v[k], fs.v[k], js.v[k])):
            assert torch.equal(got, plain), k  # the same bits as update
            np.testing.assert_allclose(
                got.to(torch.float32).numpy(),
                np.asarray(jnp.asarray(want).astype(jnp.float32)),
                rtol=0 if moment_dtype == "float32" else 1e-2, atol=1e-7)


def test_global_norm_is_one_fused_reduction():
    """Each leaf's squared norm in fp32, bf16 leaves included, against
    the reference's fp32 sum of squares."""
    tree = {"a": normal((300, 7), 1), "b": normal((5,), 2, 10.0),
            "c": normal((64, 64), 3)}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    tt["c"] = tt["c"].to(torch.bfloat16)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    jt["c"] = jt["c"].astype(jnp.bfloat16)
    got = t_opt.global_norm(tt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(j_opt.global_norm(jt)),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# Adafactor on the reference's stacked tree
# ---------------------------------------------------------------------------

def _stacked_grads(tree, seed):
    leaves = flat(tree)
    return {k: normal(v.shape, seed + i, 0.5)
            for i, (k, v) in enumerate(sorted(leaves.items()))}


def _nest(flat_tree):
    out = {}
    for key, v in flat_tree.items():
        node = out
        *path, last = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v
    return out


def _per_layer(model, stacked: dict) -> dict:
    """{port name: tensor} from a {stacked name: [L, ...] or leaf}."""
    out = {}
    for key, names in t_layers.stack_groups(
            dict(model.named_parameters())).items():
        if isinstance(names, str):
            out[names] = torch.from_numpy(stacked[key].copy())
        else:
            for i, n in enumerate(names):
                out[n] = torch.from_numpy(stacked[key][i].copy())
    return out


@pytest.mark.parametrize("arch,threshold", [
    ("qwen1.5-4b-smoke", None), ("qwen1.5-4b-smoke", 10000),
    ("granite-moe-3b-a800m-smoke", 10000)])
def test_adafactor_matches_reference_on_the_stacked_tree(
        monkeypatch, arch, threshold):
    """Norm scales [L, d] factored; above `threshold` a stacked leaf of 3
    or more dims goes a layer at a time, its rms_u clip per layer."""
    if threshold is not None:
        monkeypatch.setattr(j_opt, "CHUNKED_UPDATE_THRESHOLD", threshold)
        monkeypatch.setattr(t_opt, "CHUNKED_UPDATE_THRESHOLD", threshold)
    tree = lm_pair(arch)[1]  # the reference's initial tree, cached
    model = registry.build_model(registry.get_config(arch), "cpu")
    stacked = flat(tree)
    assert stacked["blocks.norm1.scale"].ndim == 2  # [L, d]: factored
    jopt = j_opt.Adafactor(learning_rate=1e-2, weight_decay=0.01)
    topt = t_opt.Adafactor(learning_rate=1e-2, weight_decay=0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = _per_layer(model, stacked)
    groups = t_layers.stack_groups(tp)
    js, ts = jopt.init(jp), topt.init(tp, groups=groups)
    assert set(ts.vr) == set(stacked)
    j_update = jax.jit(jopt.update)  # traced with the threshold set here
    for step in range(3):
        grads = _stacked_grads(tree, 100 * step)
        jp, js, _ = j_update(
            jax.tree_util.tree_map(jnp.asarray, _nest(grads)), js, jp)
        tp, ts, _ = topt.update(_per_layer(model, grads), ts, tp,
                                groups=groups)
    got = flat(t_layers.stack_lm_tree(tp))
    want = flat(jax.tree_util.tree_map(np.asarray, jp))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    for name, mine, theirs in (("vr", ts.vr, js.vr), ("vc", ts.vc, js.vc)):
        theirs = flat(jax.tree_util.tree_map(np.asarray, theirs))
        for k, v in theirs.items():
            np.testing.assert_allclose(mine[k].numpy(), v, rtol=1e-6,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("arch,threshold", [
    ("qwen1.5-4b-smoke", None), ("granite-moe-3b-a800m-smoke", 10000)])
def test_adafactor_update_in_place_matches_update(monkeypatch, arch,
                                                  threshold):
    """`update_` gives `update`'s bits in the tensors it was given, and
    stacks only groups of 1-D per-layer leaves (a layer at a time
    otherwise: no stacked copy of a weight group)."""
    if threshold is not None:
        monkeypatch.setattr(t_opt, "CHUNKED_UPDATE_THRESHOLD", threshold)
    tree = lm_pair(arch)[1]
    model = registry.build_model(registry.get_config(arch), "cpu")
    opt = t_opt.Adafactor(learning_rate=1e-2, weight_decay=0.01)
    start = _per_layer(model, flat(tree))
    fn_p = {k: v.clone() for k, v in start.items()}
    ip_p = {k: v.clone() for k, v in start.items()}
    held = dict(ip_p)
    groups = t_layers.stack_groups(start)
    fn_s, ip_s = opt.init(fn_p, groups), opt.init(ip_p, groups)
    stacked = []
    stack = torch.stack

    def spy(tensors, *a, **kw):
        stacked.append(max(t.ndim for t in tensors))
        return stack(tensors, *a, **kw)

    for step in range(3):
        grads = _per_layer(model, _stacked_grads(tree, 100 * step))
        fn_p, fn_s, _ = opt.update(grads, fn_s, fn_p, groups=groups)
        monkeypatch.setattr(torch, "stack", spy)
        out, ip_s, _ = opt.update_(grads, ip_s, ip_p, groups=groups)
        monkeypatch.setattr(torch, "stack", stack)
        assert out is ip_p
    assert stacked and max(stacked) <= 1
    for k in start:
        assert ip_p[k] is held[k]
        assert torch.equal(ip_p[k], fn_p[k]), k
    for k in fn_s.vr:
        assert torch.equal(ip_s.vr[k], fn_s.vr[k]), k
        assert torch.equal(ip_s.vc[k], fn_s.vc[k]), k


def test_adafactor_state_axes_and_layer_order():
    opt = t_opt.Adafactor()
    axes = opt.state_axes({"w": ("embed", "mlp"), "b": ("mlp",),
                           "e": ("layers", "embed", "mlp")})
    ref = j_opt.Adafactor().state_axes(
        {"w": ("embed", "mlp"), "b": ("mlp",),
         "e": ("layers", "embed", "mlp")})
    assert axes.vr == ref.vr and axes.vc == ref.vc
    groups = t_layers.stack_groups(["blocks.10.a", "blocks.2.a", "x"] +
                                   [f"blocks.{i}.a" for i in (0, 1, 3, 4,
                                                               5, 6, 7, 8,
                                                               9)])
    assert groups["blocks.a"] == [f"blocks.{i}.a" for i in range(11)]
    assert groups["x"] == "x"
    with pytest.raises(ValueError, match="not 0..L-1"):
        t_layers.stack_groups(["blocks.0.a", "blocks.2.a"])


def test_make_optimizer_matches_reference():
    for kind, cls in (("adamw", t_opt.AdamW), ("adafactor", t_opt.Adafactor)):
        got = t_opt.make_optimizer(kind, 3e-4, total_steps=100, warmup=10)
        want = j_opt.make_optimizer(kind, 3e-4, total_steps=100, warmup=10)
        assert isinstance(got, cls)
        assert got.weight_decay == want.weight_decay
        for step in (0, 5, 10, 60, 100, 200):
            np.testing.assert_allclose(
                got.learning_rate(torch.tensor(step)).item(),
                float(want.learning_rate(jnp.asarray(step))), rtol=1e-6)
    assert t_opt.make_optimizer("adamw", 1e-3, moment_dtype=torch.bfloat16
                                ).moment_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        t_opt.make_optimizer("sgd", 1e-3)


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------

def _ties(x: np.ndarray, scale: float) -> int:
    """Elements whose x / scale lies on a rounding tie (k + 0.5)."""
    r = x / np.float32(scale)
    return int(np.sum(np.abs(r - np.floor(r) - 0.5) < 1e-6))


def test_error_feedback_matches_reference_exactly():
    shapes = {"w": (32, 24), "b": (24,), "e": (3, 5, 7)}
    jc, tc = j_comp.ErrorFeedbackCompressor(), t_comp.ErrorFeedbackCompressor()
    zeros = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    js = jc.init({k: jnp.asarray(v) for k, v in zeros.items()})
    ts = tc.init({k: torch.from_numpy(v) for k, v in zeros.items()})
    ties = 0
    for step in range(5):
        grads = {k: normal(s, 10 * step + i, 2.0)
                 for i, (k, s) in enumerate(shapes.items())}
        for k, g in grads.items():
            x = g + ts.residual[k].numpy()
            jq, jsc = j_comp._quantize_int8(jnp.asarray(x))
            tq, tsc = t_comp.quantize_int8(torch.from_numpy(x))
            ties += _ties(x, tsc.item())
            assert tq.dtype == torch.int8
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            assert tsc.item() == float(jsc)
        jg, js = jc.compress({k: jnp.asarray(v) for k, v in grads.items()},
                             js)
        tg, ts = tc.compress({k: torch.from_numpy(v)
                              for k, v in grads.items()}, ts)
        for k in shapes:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
            np.testing.assert_array_equal(ts.residual[k].numpy(),
                                          np.asarray(js.residual[k]))
    print(f"rounding ties among the codes: {ties}")
    assert ties == 0


def test_stateless_compression_and_bind():
    g = {"a": normal((16, 9), 3, 5.0),
         "h": normal((40,), 4).astype(np.float32)}
    want = j_comp.compress_int8_stateless(
        {k: jnp.asarray(v) for k, v in g.items()})
    got = t_comp.compress_int8_stateless(
        {k: torch.from_numpy(v) for k, v in g.items()})
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    bf = t_comp.compress_int8_stateless(
        {"a": torch.from_numpy(g["a"]).to(torch.bfloat16)})
    assert bf["a"].dtype == torch.bfloat16
    comp = t_comp.ErrorFeedbackCompressor()
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    bound = comp.bind(comp.init(tg))
    state = comp.init(tg)
    for _ in range(3):
        out = bound(tg)
        want_out, state = comp.compress(tg, state)
        for k in g:
            assert torch.equal(out[k], want_out[k])
            assert torch.equal(bound.state.residual[k], state.residual[k])


# ---------------------------------------------------------------------------
# remat and the gradient dtype
# ---------------------------------------------------------------------------

REMAT_ARCHS = {"qwen1.5-4b-smoke": "blocks", "granite-moe-3b-a800m-smoke":
               "blocks", "rwkv6-3b-smoke": "blocks",
               "zamba2-1.2b-smoke": "mamba", "whisper-medium-smoke":
               "decoder"}


def _batch(cfg, seed=9, b=2, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int64)
    out = {"tokens": torch.from_numpy(toks[:, :-1]),
           "labels": torch.from_numpy(toks[:, 1:])}
    if cfg.family == "audio":
        out["audio_embeds"] = torch.from_numpy(normal((b, s, cfg.d_model),
                                                      seed + 1))
    return out


def _model(arch, remat):
    cfg = dataclasses.replace(registry.get_config(arch), remat=remat)
    model = registry.build_model(cfg, "cpu")
    return t_layers.load_jax_lm_params(model, lm_pair(arch)[1])


def _grads(model, batch):
    total, _ = t_loop.make_loss_fn(model, model.cfg)(batch)
    total.backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("arch", sorted(REMAT_ARCHS))
def test_maybe_remat_layer_and_dots_match_none(arch):
    batch = _batch(registry.get_config(arch))
    want = _grads(_model(arch, "none"), batch)
    for remat in ("layer", "dots"):
        model = _model(arch, remat)
        stack = getattr(model, REMAT_ARCHS[arch])
        calls = []
        hook = stack[0].register_forward_pre_hook(
            lambda *_: calls.append(torch.is_grad_enabled()))
        got = _grads(model, batch)
        # the block ran in the forward and again in the backward
        assert len(calls) == 2, (remat, calls)
        with torch.no_grad():
            t_loop.make_eval_step(model, model.cfg)(batch)
        assert len(calls) == 3  # once more, plain, without autograd
        hook.remove()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"{remat} {k}")


def test_dots_policy_saves_the_2d_matmuls():
    policy = t_transformer._dots_policy
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    aten = torch.ops.aten
    assert policy(None, aten.mm.default) == save
    assert policy(None, aten.addmm.default) == save
    for op in (aten.bmm.default, aten.add.Tensor, aten._to_copy.default):
        assert policy(None, op) != save
    cfg = dataclasses.replace(registry.get_config("qwen1.5-4b-smoke"),
                              remat="blocks")
    with pytest.raises(ValueError, match="unknown remat"):
        t_transformer.maybe_remat(lambda x: x, cfg)


def test_bf16_parameters_get_bf16_gradients():
    """The reference's `constrain_layer_params` barrier casts each
    layer's weight cotangent to the parameter dtype; here every `.grad`
    has its parameter's dtype by construction."""
    cfg = registry.get_config("qwen1.5-4b-smoke")
    model = t_layers.init_params(registry.build_model(cfg, "cpu"), 3)
    model.to(torch.bfloat16)
    total, _ = t_loop.make_loss_fn(model, cfg)(_batch(cfg))
    assert total.dtype == torch.float32
    total.backward()
    dtypes = {p.grad.dtype for p in model.parameters()}
    assert dtypes == {torch.bfloat16}
