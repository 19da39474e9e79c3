"""The port's kernel autotuner (`repro_torch.kernels.autotune`) and its
consult in the registry, on the CPU.

* `cache_key` gives the reference's strings (`repro.kernels.autotune`,
  imported here only), and the cache file behaves as the reference's:
  a missing, corrupt or non-dict file reads as {}, writes go through
  `.tmp` and `os.replace` with sorted keys, and the file is read once a
  process.
* The consult is off by default and `REPRO_AUTOTUNE=1` turns it on (in a
  subprocess, where the registry is imported afresh).
* Consult cases on a CUDA stand-in (the decision reads `is_cuda`, the
  shape and the dtype), with planted records, mirroring
  `tests/test_dispatch.py:314-360` for the reference: a valid record is
  applied; one naming an unknown kernel, a tile that is not built, or
  the any-order kernel on a sorted key is ignored; a CPU tensor takes
  the plain version whatever the records say; with the consult off the
  reasons are the layout rule's.  The tile a record names reaches the
  wrapper through the autograd Functions (the wrappers run their plain
  version on CPU tensors, so the tile is checked there too), and
  `describe_dispatch` shows it.
* Tuning needs the card: `tune_*` raise without one.  The tuned tiles
  themselves are held to the plain versions on the card
  (tests/test_torch_cuda.py, chip_smoke.py's `[autotune]`).
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import autotune as j_autotune

from repro_torch.core.convolutions import SimpleConv
from repro_torch.core.graph_tensor import (Adjacency, Context, EdgeSet,
                                           GraphTensor, HIDDEN_STATE,
                                           NodeSet, to_device)
from repro_torch.kernels import autotune, registry
from repro_torch.kernels.edge_mpnn import kernel as mpnn_kernel
from repro_torch.kernels.edge_mpnn.ref import edge_mpnn_ref
from repro_torch.kernels.segment_pool import kernel as seg_kernel
from repro_torch.kernels.segment_pool.ref import segment_pool_ref

SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The default cache path moved to a temporary file, the card's
    compute capability fixed at 90, and the consult on; restored after."""
    path = tmp_path / "autotune_cache_cuda.json"
    monkeypatch.setattr(autotune, "DEFAULT_CACHE_PATH", path)
    monkeypatch.setattr(autotune, "device_sm", lambda device: 90)
    autotune._LOADED.clear()
    registry.use_autotune(True)
    try:
        yield path
    finally:
        registry.use_autotune(False)
        autotune._LOADED.clear()


def cuda_like(*shape, dtype=torch.float32):
    """What a decision reads of a CUDA tensor, on the CPU."""
    return types.SimpleNamespace(is_cuda=True, device=torch.device("cuda", 0),
                                 shape=torch.Size(shape), dtype=dtype)


def pool_key(n=64, d=128, dtype="float32", reduce="sum", layout="sorted",
             e=1000):
    return autotune.pool_key(n=n, d=d, dtype=dtype, reduce=reduce,
                             layout=layout, e=e, sm=90)


def edge_key(dtype="float32", layout="unsorted", m=96, e=700):
    return autotune.edge_key(n_src=50, n_tgt=70, ds=64, dt=64, m=m,
                             dtype=dtype, activation="relu", layout=layout,
                             e=e, sm=90)


def plant(key, variant, tile):
    autotune._store(key, {"variant": variant, "tile": tile, "us": 1.0,
                          "default_us": 2.0, "candidates": {},
                          "device": "stand-in"}, None)


def pool_decision(d=128, dtype=torch.float32, sorted_ids=True, e=1000,
                  reduce="sum"):
    return registry.segment_reduce_decision(
        cuda_like(e, d, dtype=dtype), sorted_ids, n_segments=64,
        reduce=reduce)


def edge_decision(dtype=torch.float32, sorted_ids=False, m=96):
    return registry.edge_mpnn_decision(
        cuda_like(50, 64, dtype=dtype), "relu", sorted_ids,
        h_tgt=cuda_like(70, 64, dtype=dtype),
        w=cuda_like(128, m, dtype=dtype), n_edges=700)


# ---------------------------------------------------------------------------
# keys and the cache file
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,attrs", [
    ("segment_pool", dict(n=1000, d=64, dtype="float32", reduce="sum",
                          layout="sorted", backend="cuda", sm=90, e=8000)),
    ("edge_mpnn", dict(n_src=1224, n_tgt=4896, ds=128, dt=128, m=128,
                       dtype="bfloat16", activation="relu",
                       layout="unsorted", backend="cuda", sm=90, e=4896)),
    ("x", {}),
])
def test_cache_key_is_the_references(kernel, attrs):
    assert autotune.cache_key(kernel, **attrs) == \
        j_autotune.cache_key(kernel, **attrs)


def test_pool_and_edge_keys_spell_the_reference_attributes():
    """The port's keys are the reference's attributes (backend "cuda"),
    the dtype spelled as the reference's, plus sm and e; mean is keyed
    as sum."""
    assert autotune.pool_key(n=1000, d=64, dtype=torch.float32,
                             reduce="mean", layout="sorted", e=8000,
                             sm=90) == j_autotune.cache_key(
        "segment_pool", n=1000, d=64, dtype="float32", reduce="sum",
        layout="sorted", backend="cuda", sm=90, e=8000)
    assert autotune.edge_key(
        n_src=3, n_tgt=4, ds=5, dt=6, m=7, dtype=torch.bfloat16,
        activation="gelu", layout="unsorted", e=9, sm=90) == \
        j_autotune.cache_key("edge_mpnn", n_src=3, n_tgt=4, ds=5, dt=6, m=7,
                             dtype="bfloat16", activation="gelu",
                             layout="unsorted", backend="cuda", sm=90, e=9)


@pytest.mark.parametrize("content", [None, "{not json", "[1, 2]", "3"])
def test_missing_corrupt_or_non_dict_file_reads_empty(tmp_path, content):
    path = tmp_path / "cache.json"
    if content is not None:
        path.write_text(content)
    autotune._LOADED.clear()
    try:
        assert autotune._load(path) == {}
        assert autotune.lookup("k", path) is None
    finally:
        autotune._LOADED.clear()


def test_store_writes_sorted_keys_through_a_tmp_file(tmp_path, monkeypatch):
    path = tmp_path / "sub" / "cache.json"
    replaced = []
    real = os.replace

    def spy(src, dst):
        replaced.append((Path(src), Path(dst)))
        real(src, dst)

    monkeypatch.setattr(os, "replace", spy)
    autotune._LOADED.clear()
    try:
        autotune._store("b|x=1", {"variant": "v", "tile": 2}, path)
        autotune._store("a|x=1", {"tile": 0, "variant": "w"}, path)
        assert replaced == [(path.with_suffix(".tmp"), path)] * 2
        assert not path.with_suffix(".tmp").exists()
        text = path.read_text()
        assert list(json.loads(text)) == ["a|x=1", "b|x=1"]
        assert text == json.dumps(json.loads(text), indent=2,
                                  sort_keys=True) + "\n"
        assert autotune.lookup("a|x=1", path) == {"tile": 0, "variant": "w"}
    finally:
        autotune._LOADED.clear()


def test_file_is_read_once_per_process_until_cleared(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({"k": {"variant": "a"}}))
    autotune._LOADED.clear()
    try:
        assert autotune.lookup("k", path) == {"variant": "a"}
        path.write_text(json.dumps({"k": {"variant": "b"}}))
        assert autotune.lookup("k", path) == {"variant": "a"}  # memoized
        path.write_text(json.dumps({"k": 5}))
        autotune._LOADED.pop(str(path))
        assert autotune.lookup("k", path) is None  # a non-dict record
        autotune.clear(path)
        assert not path.exists() and str(path) not in autotune._LOADED
        autotune.clear(path)  # a missing file is no error
    finally:
        autotune._LOADED.clear()


def test_default_cache_is_not_the_references():
    assert autotune.DEFAULT_CACHE_PATH.name == "autotune_cache_cuda.json"
    assert autotune.DEFAULT_CACHE_PATH.parent.name == "results"
    assert autotune.DEFAULT_CACHE_PATH.name != \
        j_autotune.DEFAULT_CACHE_PATH.name


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,on", [(None, False), ("0", False),
                                      ("1", True)])
def test_consult_is_off_by_default_and_read_from_the_environment(value, on):
    env = {k: v for k, v in os.environ.items() if k != "REPRO_AUTOTUNE"}
    env["PYTHONPATH"] = SRC
    if value is not None:
        env["REPRO_AUTOTUNE"] = value
    out = subprocess.run(
        [sys.executable, "-c", "from repro_torch.kernels import registry; "
         "print(registry.autotune_enabled())"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == str(on)


def test_use_autotune_toggles():
    assert not registry.autotune_enabled()
    registry.use_autotune(True)
    try:
        assert registry.autotune_enabled()
    finally:
        registry.use_autotune(False)
    assert not registry.autotune_enabled()


# ---------------------------------------------------------------------------
# the consult
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key,variant,tile,decide,reason", [
    (pool_key(), "segment_pool_runs", 32, lambda: pool_decision(),
     "autotuned:segment_pool_runs/32[sorted]"),
    (pool_key(layout="unsorted"), "segment_pool", 0,
     lambda: pool_decision(sorted_ids=False),
     "autotuned:segment_pool/0[unsorted]"),
    (pool_key(layout="unsorted"), "segment_pool_runs", 16,
     lambda: pool_decision(sorted_ids=False),
     "autotuned:segment_pool_runs/16[unsorted]"),
    (pool_key(d=4), "segment_pool_runs", 0, lambda: pool_decision(d=4),
     "autotuned:segment_pool_runs/0[sorted]"),
    (pool_key(reduce="sum"), "segment_pool_runs", 32,
     lambda: pool_decision(reduce="mean"),
     "autotuned:segment_pool_runs/32[sorted]"),
    (edge_key(), "edge_mpnn", 128, lambda: edge_decision(),
     "autotuned:edge_mpnn/128[unsorted]"),
    (edge_key(layout="sorted"), "edge_mpnn_runs", 64,
     lambda: edge_decision(sorted_ids=True),
     "autotuned:edge_mpnn_runs/64[sorted]"),
    (edge_key(dtype="bfloat16"), "edge_mpnn_runs", 64,
     lambda: edge_decision(dtype=torch.bfloat16),
     "autotuned:edge_mpnn_runs/64[unsorted]"),
])
def test_a_valid_record_is_applied(cache, key, variant, tile, decide,
                                   reason):
    plant(key, variant, tile)
    dec = decide()
    assert dec == registry.Decision(True, reason, variant, tile)


@pytest.mark.parametrize("key,variant,tile,decide,reason", [
    # an unknown kernel (the reference's variant names included)
    (pool_key(), "runs", 16, lambda: pool_decision(),
     "kernel:segment_pool_runs[sorted]"),
    (edge_key(), "onehot", 32, lambda: edge_decision(),
     "kernel:edge_mpnn[unsorted]"),
    # a tile that is not built
    (pool_key(), "segment_pool_runs", 64, lambda: pool_decision(),
     "kernel:segment_pool_runs[sorted]"),
    (pool_key(d=4), "segment_pool_runs", 16, lambda: pool_decision(d=4),
     "kernel:segment_pool_runs[sorted]"),
    (pool_key(layout="unsorted"), "segment_pool", 16,
     lambda: pool_decision(sorted_ids=False), "kernel:segment_pool[unsorted]"),
    (edge_key(dtype="bfloat16"), "edge_mpnn", 32,
     lambda: edge_decision(dtype=torch.bfloat16),
     "kernel:edge_mpnn[unsorted]"),
    (edge_key(), "edge_mpnn", "64", lambda: edge_decision(),
     "kernel:edge_mpnn[unsorted]"),
    # the any-order kernel on a sorted key
    (pool_key(), "segment_pool", 0, lambda: pool_decision(),
     "kernel:segment_pool_runs[sorted]"),
    (edge_key(layout="sorted"), "edge_mpnn", 32,
     lambda: edge_decision(sorted_ids=True),
     "kernel:edge_mpnn_runs[sorted]"),
    # a record of another shape
    (pool_key(e=999), "segment_pool", 0,
     lambda: pool_decision(sorted_ids=False), "kernel:segment_pool[unsorted]"),
])
def test_a_record_that_cannot_run_here_is_ignored(cache, key, variant, tile,
                                                  decide, reason):
    plant(key, variant, tile)
    dec = decide()
    assert dec.use_kernel and dec.reason == reason and dec.tile == 0


def test_consult_off_or_without_a_shape_keeps_the_layout_rule(cache):
    plant(pool_key(), "segment_pool_runs", 32)
    plant(edge_key(), "edge_mpnn_runs", 128)
    assert pool_decision().reason.startswith("autotuned:")
    assert registry.segment_reduce_decision(
        cuda_like(1000, 128), True).reason == "kernel:segment_pool_runs[sorted]"
    assert registry.edge_mpnn_decision(
        cuda_like(50, 64), "relu", False).reason == "kernel:edge_mpnn[unsorted]"
    registry.use_autotune(False)
    assert pool_decision() == registry.Decision(
        True, "kernel:segment_pool_runs[sorted]", "segment_pool_runs")
    assert edge_decision() == registry.Decision(
        True, "kernel:edge_mpnn[unsorted]", "edge_mpnn")


def test_a_cpu_tensor_takes_the_plain_version_whatever_the_records(cache):
    plant(autotune.pool_key(n=64, d=8, dtype="float32", reduce="sum",
                            layout="unsorted", e=30, sm=90),
          "segment_pool_runs", 0)
    dec = registry.segment_reduce_decision(torch.zeros(30, 8), False,
                                           n_segments=64)
    assert not dec.use_kernel and dec.reason == "cpu tensor: plain version"
    with registry.plain_versions():
        assert not pool_decision().use_kernel


def _tile_spies(monkeypatch, entry_name):
    """Replace the registry entry's wrappers with spies that record the
    tile each call passes on."""
    seen = []
    entry = registry.registry()[entry_name]
    kernels = dict(entry.kernels)
    for name, fn in entry.kernels.items():
        def spy(*args, fn=fn, name=name, **kwargs):
            seen.append((name, kwargs["tile"]))
            return fn(*args, **kwargs)
        kernels[name] = spy
    monkeypatch.setitem(registry._REGISTRY, entry_name,
                        registry.KernelEntry(entry.name, kernels,
                                             entry.reference, entry.decide,
                                             entry.tiles))
    return seen


def test_the_tile_reaches_the_wrapper_through_the_functions(cache,
                                                            monkeypatch):
    """With CPU tensors let through as if on the card, the registry's
    calls carry the record's tile through SegmentPoolFunction and
    EdgeMpnnFunction to the wrappers (which run their plain versions on
    the CPU), forward and backward equal to the plain versions."""
    monkeypatch.setattr(registry, "_plain_reason", lambda t: None)
    pool_seen = _tile_spies(monkeypatch, "segment_pool")
    edge_seen = _tile_spies(monkeypatch, "edge_mpnn")
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.standard_normal((40, 3, 16)).astype(
        np.float32)).requires_grad_(True)
    ids = torch.from_numpy(np.sort(rng.integers(0, 12, 40)))
    plant(autotune.pool_key(n=12, d=48, dtype="float32", reduce="sum",
                            layout="sorted", e=40, sm=90),
          "segment_pool_runs", 32)
    out = registry.segment_reduce(vals, ids, 12, "mean", sorted_ids=True)
    assert pool_seen == [("segment_pool_runs", 32)]
    want = registry.segment_reduce(vals, ids, 12, "mean", sorted_ids=False)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    (g,) = torch.autograd.grad(out.square().sum(), vals)
    (g_want,) = torch.autograd.grad(want.square().sum(), vals)
    torch.testing.assert_close(g, g_want, rtol=1e-6, atol=1e-6)

    h_src = torch.from_numpy(rng.standard_normal((50, 64)).astype(
        np.float32)).requires_grad_(True)
    h_tgt = torch.from_numpy(rng.standard_normal((70, 64)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal((128, 96))).astype(
        np.float32)).requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, 50, 700))
    tgt = torch.from_numpy(rng.integers(0, 75, 700))  # >= 70: padding
    plant(edge_key(), "edge_mpnn_runs", 128)
    out = registry.edge_mpnn(h_src, h_tgt, src, tgt, w, b, n_src=50,
                             n_tgt=70, sorted_ids=False)
    assert edge_seen == [("edge_mpnn_runs", 128)]
    want = edge_mpnn_ref(h_src, h_tgt, src, tgt, w, b, n_src=50, n_tgt=70)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    grads = torch.autograd.grad(out.sum(), [h_src, w])
    wants = torch.autograd.grad(want.sum(), [h_src, w])
    for a, c in zip(grads, wants):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)


def _small_graph():
    """Two node sets, one edge set of 5 edges (one padding), on the CPU."""
    rng = np.random.default_rng(0)
    return to_device(GraphTensor(
        Context(np.asarray([1, 0], np.int32), {}),
        {"a": NodeSet(np.asarray([3, 0], np.int32), {
            HIDDEN_STATE: rng.standard_normal((3, 4)).astype(np.float32)},
            3),
         "b": NodeSet(np.asarray([3, 1], np.int32), {
             HIDDEN_STATE: rng.standard_normal((4, 4)).astype(np.float32)},
             4)},
        {"ab": EdgeSet(np.asarray([4, 1], np.int32), Adjacency(
            np.asarray([0, 1, 2, 2, 0], np.int32),
            np.asarray([0, 0, 1, 2, 3], np.int32), "a", "b"), {}, 5)}),
        "cpu")


def test_fused_conv_decision_shows_the_record(cache, monkeypatch):
    """SimpleConv's fused decision (what describe_dispatch reports) passes
    its shape, so a record of that shape shows; its forward runs the
    recorded kernel and tile."""
    monkeypatch.setattr(registry, "_plain_reason", lambda t: None)
    seen = _tile_spies(monkeypatch, "edge_mpnn")
    g = _small_graph()
    conv = SimpleConv(3, 8)
    assert conv.fused_decision(g, "ab").reason == "kernel:edge_mpnn[unsorted]"
    plant(autotune.edge_key(n_src=3, n_tgt=4, ds=4, dt=4, m=3,
                            dtype="float32", activation="relu",
                            layout="unsorted", e=5, sm=90),
          "edge_mpnn", 64)
    dec = conv.fused_decision(g, "ab")
    assert dec.reason == "autotuned:edge_mpnn/64[unsorted]" and dec.tile == 64
    with torch.no_grad():
        conv(g, "ab")
    assert seen == [("edge_mpnn", 64)]


# ---------------------------------------------------------------------------
# tiles, wrappers and tuning off the card
# ---------------------------------------------------------------------------

def test_built_tiles_list_the_default_first_and_fit_the_carry():
    """`tiles` lists the default height first (what a tuner's default_us
    times), and the carry scratch the wrappers size covers the smallest
    tile of each kernel."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        built = mpnn_kernel.tiles("edge_mpnn_runs", dtype, 128)
        assert built[0] == (32 if dtype == torch.float32 else 64)
        assert mpnn_kernel._RUN_TILE_EDGES <= min(built)
    assert seg_kernel.tiles("segment_pool_runs", torch.float32, 32) == (16, 32)
    assert seg_kernel.tiles("segment_pool_runs", torch.float32, 31) == ()
    assert seg_kernel.tiles("segment_pool", torch.float32, 128) == ()
    assert seg_kernel._RUN_PIECE_ROWS <= min(seg_kernel._RUN_TILES)


def test_wrappers_take_built_tiles_and_refuse_others_on_the_cpu():
    rng = np.random.default_rng(1)
    vals = torch.from_numpy(rng.standard_normal((30, 40)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 9, 30).astype(np.int32))
    want = segment_pool_ref(vals, ids, n_segments=8)
    for tile in (0, 16, 32):
        assert torch.equal(seg_kernel.segment_pool_runs(
            vals, ids, n_segments=8, tile=tile), want)
    for kernel, x, tile in ((seg_kernel.segment_pool_runs, vals, 64),
                            (seg_kernel.segment_pool_runs, vals[:, :4], 16),
                            (seg_kernel.segment_pool, vals, 16)):
        with pytest.raises(ValueError, match="tile"):
            kernel(x, ids, n_segments=8, tile=tile)
    h = torch.from_numpy(rng.standard_normal((9, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 5)).astype(np.float32))
    b = torch.zeros(5)
    want = edge_mpnn_ref(h, h, ids, ids, w, b, n_src=9, n_tgt=9)
    for tile in (0, 32, 64, 128):
        assert torch.equal(mpnn_kernel.edge_mpnn_runs(
            h, h, ids, ids, w, b, n_src=9, n_tgt=9, tile=tile), want)
    for dtype, tile in ((torch.float32, 16), (torch.float32, 48),
                        (torch.bfloat16, 32), (torch.float16, 128)):
        args = [x.to(dtype) for x in (h, h)]
        with pytest.raises(ValueError, match="tile"):
            mpnn_kernel.edge_mpnn(args[0], args[1], ids, ids, w.to(dtype),
                                  b.to(dtype), n_src=9, n_tgt=9, tile=tile)


@pytest.mark.parametrize("tune", [
    lambda: autotune.tune_segment_pool(64, 16, n_edges=256, iters=1),
    lambda: autotune.tune_edge_mpnn(8, 8, 4, 4, 4, n_edges=32, iters=1),
])
def test_tuning_raises_without_a_card(tune, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(autotune, "DEFAULT_CACHE_PATH", tmp_path / "c.json")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tune()
    assert not (tmp_path / "c.json").exists()
