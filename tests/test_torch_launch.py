"""The launch layer against the JAX package's, on the CPU.

* `make_cell` for every runnable cell against the reference's: kind,
  donated arguments, rule overrides, and every train, prefill and decode
  argument's shape, dtype and logical axes (the port's per-layer
  parameters and their state restacked onto the reference's stacked
  leaves, `stack_groups`).
* `step_flops` equal, `step_hbm_bytes` equal at the reference's depth,
  for every cell; `auto_microbatches` picks the reference's depth under
  the reference's budget (and under others), so its memory model's terms
  sum as the reference's; the port's own depth is printed beside it.
* A 1-layer smoke forward's counted FLOPs within 2x of `step_flops`, as
  `tests/test_roofline.py` holds XLA's count.
* The dry run's tally: its peak on meta tensors equals its peak on real
  CPU tensors for a one-rank smoke step; `make_production_mesh` raises
  below 256 ranks; `make_host_mesh` and the roofline's terms.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch import roofline as j_roofline
from repro.launch import specs as j_specs
from repro.models import registry as j_registry
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun, mesh, roofline, specs
from repro_torch.models import registry
from repro_torch.nn.layers import stack_groups

CELLS = registry.runnable_cells()


def test_the_cells_are_the_reference_cells():
    assert CELLS == j_registry.runnable_cells()
    assert len(CELLS) == 32


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


def _sig(x) -> tuple:
    return tuple(x.shape), _dtype(x)


def _stacked(tree: dict) -> dict:
    """The port's per-layer {name: meta tensor} as the reference's
    stacked leaves' (shape, dtype)."""
    out = {}
    for key, names in stack_groups(tree).items():
        if isinstance(names, str):
            out[key] = _sig(tree[names])
        else:
            shape, dtype = _sig(tree[names[0]])
            assert all(_sig(tree[n]) == (shape, dtype) for n in names)
            out[key] = ((len(names),) + shape, dtype)
    return out


def _stacked_axes(axes: dict) -> dict:
    out = {}
    for key, names in stack_groups(axes).items():
        out[key] = (tuple(axes[names]) if isinstance(names, str)
                    else ("layers",) + tuple(axes[names[0]]))
    return out


def _ref_sigs(tree) -> dict:
    return {k: _sig(v) for k, v in _flat(tree).items()}


def _ref_axes(tree) -> dict:
    def walk(t, prefix=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(walk(v, f"{prefix}.{k}" if prefix else str(k)))
            return out
        return {prefix: tuple(t)}
    return walk(tree)


def _state_sigs(state) -> dict:
    """An optimizer state's leaves as {field.name: (shape, dtype)}, the
    port's per-layer moments restacked."""
    out = {"step": _sig(state.step)}
    for field in state._fields[1:]:
        tree = getattr(state, field)
        flat = _flat(tree)
        if all(isinstance(v, torch.Tensor) for v in flat.values()) and any(
                k.startswith(("blocks.", "mamba.", "encoder.", "decoder."))
                and k.split(".")[1].isdigit() for k in flat):
            flat = _stacked(flat)
        else:
            flat = {k: _sig(v) for k, v in flat.items()}
        out.update({f"{field}/{k}": v for k, v in flat.items()})
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_make_cell_matches_reference(arch, shape):
    ref = j_specs.make_cell(arch, shape)
    got = specs.make_cell(arch, shape)
    assert (got.kind, got.donate, got.rule_overrides) == (
        ref.kind, ref.donate, ref.rule_overrides)
    assert got.cfg.name == ref.cfg.name and got.shape.name == ref.shape.name
    # parameters: shapes, dtypes, logical axes
    assert _stacked(got.args[0]) == _ref_sigs(ref.args[0])
    assert _stacked_axes(got.arg_axes[0]) == _ref_axes(ref.arg_axes[0])
    if got.kind == "train":
        assert type(got.args[1]).__name__ == type(ref.args[1]).__name__
        ref_state = {f"{f}/{k}" if f != "step" else "step": v
                     for f in ref.args[1]._fields
                     for k, v in (_ref_sigs(getattr(ref.args[1], f)).items()
                                  if f != "step" else
                                  [("", _sig(ref.args[1].step))])}
        assert _state_sigs(got.args[1]) == ref_state
        for f in ref.arg_axes[1]._fields[1:]:
            mine = getattr(got.arg_axes[1], f)
            if type(ref.args[1]).__name__ == "AdamWState":
                mine = _stacked_axes(mine)  # Adafactor's are stacked
            assert mine == _ref_axes(getattr(ref.arg_axes[1], f)), f
        batch, axes = got.args[2], got.arg_axes[2]
        ref_batch, ref_axes = ref.args[2], ref.arg_axes[2]
    elif got.kind == "prefill":
        batch, axes = got.args[1], got.arg_axes[1]
        ref_batch, ref_axes = ref.args[1], ref.arg_axes[1]
    else:
        assert _sig(got.args[1]) == _sig(ref.args[1])
        assert tuple(got.arg_axes[1]) == tuple(ref.arg_axes[1])
        cache, ref_cache = got.args[2], ref.args[2]
        cache_axes, ref_cache_axes = got.arg_axes[2], ref.arg_axes[2]
        for field in dataclasses.fields(cache):
            mine, want = getattr(cache, field.name), getattr(ref_cache,
                                                             field.name)
            if isinstance(mine, torch.Tensor):
                assert _sig(mine) == _sig(want), field.name
            else:  # a host int here, an int32 scalar there
                assert tuple(want.shape) == (), field.name
            assert tuple(getattr(cache_axes, field.name)) == tuple(
                getattr(ref_cache_axes, field.name)), field.name
        return
    assert {k: _sig(v) for k, v in batch.items()} == _ref_sigs(ref_batch)
    assert {k: tuple(v) for k, v in axes.items()} == _ref_axes(ref_axes)


def _ref_cfg_shape(arch, shape):
    return j_registry.get_config(arch), j_base.SHAPES[shape]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_step_flops_and_hbm_bytes_match_reference(arch, shape):
    cfg, shp = registry.get_config(arch), SHAPES[shape]
    jcfg, jshp = _ref_cfg_shape(arch, shape)
    for skip in (False, True):
        assert roofline.step_flops(cfg, shp, causal_skip=skip) == \
            j_roofline.step_flops(jcfg, jshp, causal_skip=skip)
    depth = (j_specs.auto_microbatches(jcfg, jshp)
             if shp.kind == "train" else None)
    for chips in (256, 512):
        assert roofline.step_hbm_bytes(cfg, shp, chips, depth) == \
            j_roofline.step_hbm_bytes(jcfg, jshp, chips)


TRAIN_CELLS = [(a, s) for a, s in CELLS if SHAPES[s].kind == "train"]


@pytest.mark.parametrize("arch,shape", TRAIN_CELLS)
def test_microbatch_memory_model_matches_reference(monkeypatch, arch,
                                                   shape):
    """Under the reference's budget, and under budgets that cross every
    depth's threshold, the port picks the reference's depth: the terms
    sum to the reference's at every depth.  The port's own depth (one
    H100 less the rank's state) is printed beside the reference's."""
    cfg, shp = registry.get_config(arch), SHAPES[shape]
    jcfg, jshp = _ref_cfg_shape(arch, shape)
    def port(budget):  # the state that leaves `budget` of one card
        return specs.auto_microbatches(
            cfg, shp, state_bytes=specs.HBM_PER_CARD - budget)

    assert port(j_specs.ACT_BUDGET_BYTES) == \
        j_specs.auto_microbatches(jcfg, jshp)
    b_dev = shp.global_batch // 16
    n = 1
    while n <= b_dev:
        total = sum(specs.microbatch_terms(cfg, shp, n).values())
        for b in (total - 1, total):
            monkeypatch.setattr(j_specs, "ACT_BUDGET_BYTES", b)
            assert port(b) == j_specs.auto_microbatches(jcfg, jshp), (n, b)
        n *= 2
    terms = specs.microbatch_terms(cfg, shp, 1)
    assert terms["headroom"] == 1.5 * 1024 ** 3
    print(f"{arch} {shape}: reference depth "
          f"{j_specs.auto_microbatches(jcfg, jshp)} (its budget), the "
          f"port's {_port_depth(arch, shape)} (one H100 less the one-card "
          "state)")


def _port_depth(arch, shape):
    cfg, shp = registry.get_config(arch), SHAPES[shape]
    model = specs._cast_params(registry.build_model(cfg, "meta"), cfg)
    state = specs.train_state_bytes(dict(model.named_parameters()),
                                    specs.pick_optimizer(cfg))
    return specs.auto_microbatches(cfg, shp, state_bytes=sum(state.values()))


def test_smoke_forward_flops_within_2x_of_the_formula():
    cfg = dataclasses.replace(registry.get_config("deepseek-7b-smoke"),
                              num_layers=1, remat="none")
    model = registry.build_model(cfg, "cpu")
    b, s = 2, 64
    tokens = torch.zeros(b, s, dtype=torch.int64)
    with torch.no_grad(), dryrun.MemoryTally() as tally:
        tally.flops = 0
        model(tokens)
    analytic = roofline.step_flops(cfg, ShapeConfig("t", s, b, "prefill"))
    assert 0.5 < analytic["compiled_flops"] / tally.flops < 2.0, (
        analytic, tally.flops)


def _smoke_step(device: str) -> dict:
    cfg = registry.get_config("qwen1.5-4b-smoke")
    return dryrun.trace_train(
        cfg, specs.pick_optimizer(cfg),
        {"tokens": ((2, 64), torch.int64), "labels": ((2, 64), torch.int64)},
        n_microbatches=2, device=device)


def test_tally_on_meta_tensors_equals_real():
    """The dry run's tensors are meta (shapes without data): its figures
    for a one-rank smoke step equal the same step's on real CPU
    tensors, the shape cache's outputs included."""
    real, fake = _smoke_step("cpu"), _smoke_step("meta")
    assert fake["peak"] == real["peak"]
    assert fake["setup_peak"] == real["setup_peak"]
    assert fake["flops"] == real["flops"] > 0
    assert fake["held"] == real["held"]
    # parameters, their gradients and AdamW's two moments are all live
    # at the peak of the backward
    params = real["held"]["params"]
    assert real["peak"]["params"] == params
    assert real["peak"]["opt_state"] == real["held"]["opt_state"]
    assert real["peak"]["total"] > 2 * params


def test_tally_frees_what_dies():
    with dryrun.MemoryTally() as tally:
        a = torch.zeros(1000)
        b = a[10:]      # a view: counted once
        c = a + 1
        assert tally.live == 8000
        del a, b
        assert tally.live == 4000
        d = torch.zeros(10)
        del c, d
    assert tally.peak == 8000


def test_production_mesh_needs_its_ranks():
    with pytest.raises(RuntimeError, match="need 256 ranks, have 1"):
        mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        mesh.make_production_mesh(multi_pod=True)
    m = mesh.make_host_mesh()
    assert (m.axis_names, m.shape) == (("data",), {"data": 1})
    with pytest.raises(ValueError, match="host mesh"):
        mesh.make_host_mesh(1, shape=(2, 2))


def test_roofline_terms_read_the_dry_run_row():
    cfg, shp = registry.get_config("qwen1.5-4b"), SHAPES["decode_32k"]
    row = {"arch": "qwen1.5-4b", "shape": "decode_32k", "mesh": "16x16",
           "n_chips": 256, "n_microbatches": 1,
           "collectives": {"per_axis": {
               "model": {"count": 1, "bytes": 50e9},
               "data": {"count": 1, "bytes": 450e9}}},
           "axis_ranks": {"model": list(range(16)),
                          "data": list(range(0, 256, 16))}}
    r = roofline.analyze(row)
    assert r.collective_s == pytest.approx(1.0 + 9.0)  # both cross nodes
    row["axis_ranks"]["data"] = list(range(8))          # inside one node
    assert roofline.analyze(row).collective_s == pytest.approx(1.0 + 1.0)
    fl = roofline.step_flops(cfg, shp)
    assert r.compute_s == fl["compiled_flops"] / (256 * 989e12)
    assert r.memory_s == roofline.step_hbm_bytes(cfg, shp, 256) / (
        256 * 3.35e12)
    assert r.bottleneck == "collective"
