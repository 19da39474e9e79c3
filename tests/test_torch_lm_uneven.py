"""Uneven splits over "model" as the reference resolves them, on the CPU.

The reference's resolver (`repro.distributed.sharding.ShardingContext.
resolve`) puts a mesh axis on a parameter dim only where it divides it,
greedily from the left, so a leaf whose first model-ruled axis does not
divide falls through to the next one that does: granite's 40 experts at
16 cut each expert by its hidden width ("mlp"), and heads that do not
divide (qwen1.5-4b's 20, granite's 24 / 8, arctic's 56 / 8) are cut by
their fused heads x head_dim columns.  The port places every leaf so
(`MeshPlan.place_params_`): an MoE layer cut by width computes partial
sums over the axis, attention cut at rest gathers its weights whole at
each call, and an RWKV6 time mix whose heads do not divide (rwkv6-3b's
40 at 16) gathers its weights so and runs by value columns, its wkv
state cut on its value dim as the reference's.

* (a) every leaf of every arch `build_model` builds, on meta tensors at
  16 x 16 and 2 x 16 x 16: the spec the port's placement gives (its
  "model" dim from the split, its "data" dim from FSDP's cut) equals
  the reference's ``resolve(axes, DEFAULT_PARAM_RULES, shape=...)`` of
  the reference's own axes and whole shape.  The resolver reads only
  ``axis_names`` and ``devices.shape``, so a stand-in mesh serves.
  A known difference would be listed by name (`KNOWN_GAPS`); none is
  left: rwkv6-3b's wkv cache is cut on its value dim at 16 in both
  packages (the port's time mix by value columns);
* (b) one `MoELayer` cut by hidden width on a stand-in `Axis` of 3
  ranks (no process group: ``reduce=False`` gives each rank's part and
  nothing is reduced), the parts summed by hand, against the whole
  layer: the output, the auxiliary values (alike on every rank, bit for
  bit) and the gradients of the router, the experts and the input;
* (b') one `RWKV6TimeMix` cut by value columns on a stand-in `Axis` of
  2 ranks, the ranks' forwards side by side in threads that hand each
  other their tensors (`_lockstep`: the gathers of the weights cut at
  rest and ``ln_x``'s statistics), the parts summed by hand, against
  the whole layer in float64 at 1e-10: output, state, every gradient,
  and a decode step;
* (c) the dry run's ``rest_by_part`` on a ``-smoke`` cell sums to its
  ``rest``, and the peak and every category are byte-equal with and
  without the breakdown.

The step held to the reference's on a JAX CPU mesh (granite with 3
experts and 3 heads over 1 kv head, rwkv6 with 3 heads of 32 by value
columns, at (data=2, model=2), and rwkv6's serving from its cache cut
by value columns) is in `tests/test_torch_lm_tp_families.py`; the same
rwkv6 case under the "seq" rule in `tests/test_torch_lm_seq.py`.
"""
import dataclasses
import re
import threading
import types

import jax
import numpy as np
import pytest
import torch

from repro.distributed.sharding import (DEFAULT_ACT_RULES, DEFAULT_PARAM_RULES,
                                       ShardingContext)
from repro.models import registry as j_registry
from repro.nn.module import split_params

from repro_torch.distributed import fsdp
from repro_torch.distributed.collectives import Axis
from repro_torch.distributed.partition import Mesh, plan_for
from repro_torch.models import registry
from repro_torch.nn import layers as t_layers
from repro_torch.nn import moe as t_moe
from repro_torch.nn import ssm as t_ssm

MESHES = {"16x16": 1, "2x16x16": 2}

# where the port's layout knowingly differs from the reference's: name ->
# why (ROADMAP.md, queue 1 follow-ups); none is left
KNOWN_GAPS: dict = {}


def stand_in_plan(pods: int):
    """A plan of rank 0 of the production mesh with no process group
    (placement on meta tensors calls no collective)."""
    names = (("pod",) if pods > 1 else ()) + ("data", "model")
    shape = dict(zip(names, ((pods,) if pods > 1 else ()) + (16, 16)))
    axes = {n: Axis(n, shape[n], 0) for n in names}
    batch = Axis("pod+data", 16 * pods, 0) if pods > 1 else None
    mesh = Mesh(names, shape, 0, axes, Axis("world", 256 * pods, 0), "fake",
                batch)
    return plan_for(mesh, device="cpu")


def reference_specs(arch: str, pods: int) -> dict:
    """{dotted stacked name: (spec, whole shape)} of the reference's
    parameters under its resolver at the production mesh."""
    model = j_registry.build_model(j_registry.get_config(arch))
    values, axes = split_params(jax.eval_shape(model.init,
                                               jax.random.PRNGKey(0)))
    grid = types.SimpleNamespace(
        axis_names=(("pod",) if pods > 1 else ()) + ("data", "model"),
        devices=np.empty(((pods,) if pods > 1 else ()) + (16, 16)))
    ctx = ShardingContext(grid, DEFAULT_PARAM_RULES, DEFAULT_PARAM_RULES)
    flat_v = jax.tree_util.tree_flatten_with_path(values)[0]
    flat_a = jax.tree_util.tree_leaves(
        axes, is_leaf=lambda x: isinstance(x, tuple))
    out = {}
    for (path, v), a in zip(flat_v, flat_a):
        name = ".".join(re.findall(r"\['([^']*)'\]",
                                   jax.tree_util.keystr(path)))
        spec = ctx.resolve(a, DEFAULT_PARAM_RULES, shape=v.shape)
        out[name] = (tuple(spec), tuple(v.shape), tuple(a))
    return out


def port_specs(arch: str, pods: int) -> tuple:
    """({port name: spec}, {port name: whole shape}) of the port's
    placement: "model" on the dim the split cut, "data" on the dim
    FSDP's cut recorded (``fsdp_cut``)."""
    model = registry.build_model(registry.get_config(arch), "meta")
    plan = stand_in_plan(pods)
    layout = plan.place_params_(model)
    cuts = {}
    for prefix, mod in model.named_modules():
        for leaf, (dim, axis) in getattr(mod, "fsdp_cut", {}).items():
            cuts[f"{prefix}.{leaf}" if prefix else leaf] = (dim, axis.name)
    specs = {}
    for k, p in model.named_parameters():
        spec = [None] * len(layout.full[k])
        if layout.model_dims[k] >= 0:
            spec[layout.model_dims[k]] = "model"
        if k in cuts:
            dim, name = cuts[k]
            assert spec[dim] is None, (k, spec, cuts[k])
            spec[dim] = name
            assert p.shape[dim] * 16 == layout.full[k][dim], k
        specs[k] = tuple(spec)
    return specs, layout.full


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(registry.ARCH_IDS))
def test_placement_spec_equals_the_reference_resolver(arch, mesh):
    pods = MESHES[mesh]
    want = reference_specs(arch, pods)
    got, full = port_specs(arch, pods)
    seen = set()
    for k, spec in got.items():
        m = t_layers._LAYER_NAME.match(k)
        ref = f"{m[1]}.{m[3]}" if m else k
        wspec, wshape, waxes = want[ref]
        if m:  # a layer of a stack: the reference's leading "layers" dim
            assert waxes[0] == "layers" and wspec[0] is None, (k, waxes)
            wspec, wshape = wspec[1:], wshape[1:]
        assert wshape == full[k], (k, wshape, full[k])
        wspec += (None,) * (len(wshape) - len(wspec))
        assert spec == wspec, f"{arch} {mesh} {k}: port {spec}, reference " \
            f"{wspec} (axes {waxes}, shape {wshape})"
        seen.add(ref)
    assert seen == set(want), sorted(set(want) ^ seen)


def test_known_gap_rwkv6_wkv_cache():
    """The gap this test once pinned is closed: the reference cuts
    rwkv6-3b's wkv state on its value dim at 16 (its 40 heads do not
    divide: heads -> mlp, `repro/models/rwkv.py:95-101`), and so does
    the port, whose time mix runs by value columns there, at 16x16 and
    2x16x16: its cache holds 4 of 64 value columns of every head a
    rank.  `KNOWN_GAPS` is empty."""
    from repro.models.rwkv import RWKV6LM as JRWKV
    cfg = j_registry.get_config("rwkv6-3b")
    h, p = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    wkv_axes = JRWKV(cfg).cache_axes().wkv
    for pods in MESHES.values():
        names = (("pod",) if pods > 1 else ()) + ("data", "model")
        ctx = ShardingContext(types.SimpleNamespace(
            axis_names=names,
            devices=np.empty(((pods,) if pods > 1 else ()) + (16, 16))),
            DEFAULT_PARAM_RULES, DEFAULT_ACT_RULES)
        batch = 16 * pods
        spec = tuple(ctx.resolve(wkv_axes, ctx.act_rules,
                                 shape=(cfg.num_layers, batch, h, p, p)))
        assert spec[2] is None and spec[4] == "model", spec
        model = registry.build_model(registry.get_config("rwkv6-3b"),
                                     "meta")
        layout = stand_in_plan(pods).place_params_(model)
        tm = model.blocks[0].tm
        assert tm.axis is not None and tm.cut == "value"
        assert tm.n_heads == h and tm.value_dim == p // 16
        assert tm.r.rest_cut is not None and tm.o.rest_cut is not None
        assert "blocks.0.tm.bonus_u" in layout.partial
        whole = tuple(JRWKV(cfg).init_cache(batch).wkv.shape)
        held = tuple(model.init_cache(batch).wkv.shape)
        # "model" on each dim a rank holds 1/16 of (the batch dim is
        # the caller's rows)
        port = tuple("model" if w == 16 * g else None
                     for w, g in zip(whole, held))
        assert port == (None, None, None, None, "model"), (whole, held)
        assert port[2:] == spec[2:], (pods, port, spec)
    assert KNOWN_GAPS == {}


# ---------------------------------------------------------------------------
# (b) an MoE layer cut by hidden width, the parts summed by hand
# ---------------------------------------------------------------------------

def test_moe_cut_by_width_sums_to_the_whole_layer():
    ranks = 3
    rng = np.random.default_rng(31)
    x_np = rng.standard_normal((2, 12, 16)).astype(np.float32)
    w_np = rng.standard_normal((2, 12, 16)).astype(np.float32)

    def layer():
        mod = t_moe.MoELayer(16, 24, 4, 2, capacity_factor=0.5,
                             capacity_multiple=1, n_groups=2)
        t_layers.init_params(mod, 7)
        return mod

    def run(mod):
        x = torch.from_numpy(x_np).requires_grad_(True)
        y, aux = mod(x, reduce=False)
        (y * torch.from_numpy(w_np)).sum().backward()
        return y.detach(), aux, x.grad, {k: p.grad.clone() for k, p in
                                         mod.named_parameters()}

    whole = layer()
    y0, aux0, gx0, g0 = run(whole)
    assert float(aux0.drop_fraction) > 0   # capacity 6 of 12 x 2 drops
    parts = []
    for i in range(ranks):
        mod = layer()
        assert mod.split_(Axis("model", ranks, i))
        assert mod.cut == "mlp" and mod.wi.shape == (4, 16, 8)
        assert mod.wo.shape == (4, 8, 16)
        parts.append(run(mod))
    y = sum(p[0] for p in parts)
    torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-6)
    for _, aux, _, _ in parts:  # routing alike on every rank, bit for bit
        for a, b in zip(aux, aux0):
            assert torch.equal(a, b)
    torch.testing.assert_close(sum(p[2] for p in parts), gx0, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(sum(p[3]["router.w"] for p in parts),
                               g0["router.w"], rtol=1e-5, atol=1e-6)
    for name, dim in (("wi", 2), ("wg", 2), ("wo", 1)):
        got = torch.cat([p[3][name] for p in parts], dim=dim)
        torch.testing.assert_close(got, g0[name], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# (b') an RWKV6 time mix cut by value columns, the parts summed by hand
# ---------------------------------------------------------------------------

def _lockstep(ranks: int):
    """Stand-ins of the two collectives a value-cut time mix calls with
    ``reduce=False`` (`fsdp.gather_cut`, `layers.sum_over`), for `ranks`
    threads that run the ranks' forwards side by side with no process
    group: each call hands every thread every rank's tensor, so one
    autograd graph joins the ranks.  A gather's backward is then the sum
    of every rank's gradient of the whole (``alike``: this rank's
    alone), a sum's the sum of every rank's, as the collectives'."""
    slots, barrier = [None] * ranks, threading.Barrier(ranks)

    def exchange(t, axis):
        slots[axis.index] = t
        barrier.wait()
        got = list(slots)
        barrier.wait()
        return got

    def gather_cut(part, axis, dim, *, alike=False):
        parts = exchange(part, axis)
        if alike:
            parts = [q if j == axis.index else q.detach()
                     for j, q in enumerate(parts)]
        return torch.cat(parts, dim)

    def sum_over(t, axis):
        return torch.stack(exchange(t, axis)).sum(0)
    return gather_cut, sum_over


def test_rwkv6_time_mix_by_value_columns_sums_to_the_whole_layer(
        monkeypatch):
    """3 heads of 32 on a stand-in `Axis` of 2 ranks: the heads do not
    split, so each rank takes 16 value columns of every head
    (``reduce=False``: its part of ``o``'s sum); r, k, v, g and o stay
    cut at rest and are gathered whole, ``ln_x`` takes its statistics
    over the parts.  Against the whole layer in float64 at 1e-10: the
    output, the final state (the ranks' columns side by side), the
    gradients of every leaf (a whole leaf's summed over the ranks, a
    leaf cut at rest concatenated), of the input and of the initial
    state; then one decode step from the parts' states."""
    ranks, d, p, q = 2, 96, 32, 16
    rng = np.random.default_rng(34)
    x_np, w_np = (rng.standard_normal((2, 20, d)) for _ in range(2))
    shift_np = rng.standard_normal((2, d))
    wkv_np, ws_np = (0.3 * rng.standard_normal((2, 3, p, p))
                     for _ in range(2))
    tok_np = rng.standard_normal((2, 1, d))
    noise = {}

    def layer():
        mod = t_layers.init_params(t_ssm.RWKV6TimeMix(d, head_dim=p), 9)
        with torch.no_grad():  # mu, mu_x and bonus_u start at zero
            for k, t in mod.named_parameters():
                if k not in noise:
                    noise[k] = 0.1 * rng.standard_normal(tuple(t.shape))
                t.add_(torch.from_numpy(noise[k]).to(t.dtype))
        return mod.double()

    def cols(t, i):
        return t[..., i * q:(i + 1) * q]

    def run(mod, i=None):
        x = torch.from_numpy(x_np).requires_grad_(True)
        wkv = torch.from_numpy(wkv_np if i is None else
                               cols(wkv_np, i).copy()).requires_grad_(True)
        y, last, state = mod(x, torch.from_numpy(shift_np), wkv,
                             reduce=i is None)
        return x, wkv, y, last, state

    whole = layer()
    x0, wkv0, y0, last0, state0 = run(whole)
    ((y0 * torch.from_numpy(w_np)).sum()
     + (state0 * torch.from_numpy(ws_np)).sum()).backward()
    mods = [layer() for _ in range(ranks)]
    for i, mod in enumerate(mods):
        assert mod.split_(Axis("model", ranks, i))
        assert mod.cut == "value" and mod.value_dim == q
        assert mod.n_heads == 3 and mod.r.w.shape == (d, d // 2)
        assert mod.o.w.shape == (d // 2, d)
    gather_cut, sum_over = _lockstep(ranks)
    monkeypatch.setattr(fsdp, "gather_cut", gather_cut)
    monkeypatch.setattr(t_layers, "sum_over", sum_over)
    outs = [None] * ranks

    def rank(i):
        outs[i] = run(mods[i], i)

    threads = [threading.Thread(target=rank, args=(i,))
               for i in range(ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert all(o is not None for o in outs)
    y = sum(o[2] for o in outs)
    state = torch.cat([o[4] for o in outs], dim=-1)
    ((y * torch.from_numpy(w_np)).sum()
     + (state * torch.from_numpy(ws_np)).sum()).backward()
    tol = dict(rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(y, y0, **tol)
    torch.testing.assert_close(state, state0, **tol)
    for o in outs:
        torch.testing.assert_close(o[3], last0, **tol)
    torch.testing.assert_close(sum(o[0].grad for o in outs), x0.grad, **tol)
    torch.testing.assert_close(torch.cat([o[1].grad for o in outs], -1),
                               wkv0.grad, **tol)
    cut = {"r.w": 1, "k.w": 1, "v.w": 1, "g.w": 1, "o.w": 0}
    grads = [dict(m.named_parameters()) for m in mods]
    for k, g in whole.named_parameters():
        parts = [r[k].grad for r in grads]
        got = (torch.cat(parts, cut[k]) if k in cut
               else torch.stack(parts).sum(0))
        torch.testing.assert_close(got, g.grad, **tol, msg=k)
        assert g.grad.abs().max() > 0, k
    # one decode step from the parts' states, o's parts summed by hand
    monkeypatch.setattr(t_ssm, "reduce_from", lambda t, axis: t)
    monkeypatch.setattr(t_ssm, "copy_to", lambda t, axis: t)
    tok = torch.from_numpy(tok_np)
    with torch.no_grad():
        want = whole.decode_step(tok, last0, state0)
        steps = [None] * ranks

        def decode(i):
            steps[i] = mods[i].decode_step(tok, outs[i][3], outs[i][4])

        threads = [threading.Thread(target=decode, args=(i,))
                   for i in range(ranks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    torch.testing.assert_close(sum(s[0] for s in steps), want[0], **tol)
    torch.testing.assert_close(torch.cat([s[2] for s in steps], -1),
                               want[2], **tol)


def test_moe_split_prefers_experts_then_width():
    mod = t_moe.MoELayer(16, 24, 4, 2)
    assert mod.split_(Axis("model", 2, 1)) and mod.cut == "expert"
    assert mod.wi.shape == (2, 16, 24) and mod.expert_start == 2
    mod = t_moe.MoELayer(16, 20, 3, 2)
    assert not mod.split_(Axis("model", 8, 0)) and mod.cut is None
    assert mod.wi.shape == (3, 16, 20)


# ---------------------------------------------------------------------------
# (c) the dry run's rest by layer part
# ---------------------------------------------------------------------------

def tally_smoke(parts: bool) -> dict:
    from repro_torch.launch.dryrun import trace_train
    from repro_torch.train.optimizer import AdamW
    cfg = dataclasses.replace(registry.get_config("granite-moe-3b-a800m-smoke"),
                              remat="dots")
    tokens = ((2, 64), torch.int32)
    return trace_train(cfg, AdamW(learning_rate=1e-4),
                       {"tokens": tokens, "labels": tokens}, parts=parts)


def test_rest_by_part_sums_to_rest_and_moves_no_byte():
    plain = tally_smoke(False)
    split = tally_smoke(True)
    assert "rest_by_part" not in plain
    assert plain["peak"] == split["peak"]
    assert plain["setup_peak"] == split["setup_peak"]
    assert plain["flops"] == split["flops"]
    by_part = split["rest_by_part"]
    assert sum(by_part.values()) == split["peak"]["rest"]
    assert split["peak"]["rest"] > 0
    from repro_torch.launch.dryrun import REST_PARTS
    assert {k.split("/")[0] for k in by_part} <= set(REST_PARTS)
    assert {k.split("/")[1] for k in by_part} <= {"forward", "recompute",
                                                  "backward"}


# ---------------------------------------------------------------------------
# the step's uneven cases fall through as intended
# ---------------------------------------------------------------------------

def test_the_step_cases_fall_through_at_model_two():
    """`torch_lm_mesh_ranks.TP_CASES`' uneven cases, which
    `tests/test_torch_lm_tp_families.py` holds to the reference's mesh
    step: at model=2 granite's 3 experts are cut by their hidden width
    and its 3 / 1 heads at rest, rwkv6's 3 heads of 32 by value columns
    (16 a rank), their weights at rest."""
    import torch_lm_mesh_ranks as R
    axis = Axis("model", 2, 1)
    granite = registry.build_model(
        R.config(registry, R.TP_CASES["granite_uneven"]), "meta")
    granite.split_(axis)
    block = granite.blocks[0]
    assert block.ffn.cut == "mlp" and block.ffn.wi.shape == (3, 128, 32)
    assert block.attn.axis is None and block.attn.cut_at_rest() is axis
    assert block.attn.wq.w.shape == (128, 48)
    assert block.attn.wk.w.shape == (128, 16)
    assert block.attn.wo.w.shape == (48, 128)
    rwkv = registry.build_model(
        R.config(registry, R.TP_CASES["rwkv_uneven"]), "meta")
    rwkv.split_(axis)
    tm = rwkv.blocks[0].tm
    assert tm.axis is axis and tm.cut == "value" and tm.n_heads == 3
    assert tm.value_dim == 16
    assert tm.r.w.shape == (96, 48) and tm.o.w.shape == (48, 96)
    assert tm.r.rest_cut == ("column", axis)
    assert rwkv.blocks[0].cm.axis is not None
