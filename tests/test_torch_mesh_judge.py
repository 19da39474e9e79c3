"""The judge of `chip_smoke.py`'s `[lm-mesh]` checks, on synthetic
records on the CPU (no card, no process group).

A rank's parameter element past the strict tolerance of its one-rank
run is judged by its gradients (`lm_mesh_verdicts`): it passes where
every step's two gradients are within ``1e-6 + 1e-4 |g|``; as a root
where its step-1 gradients are within that rule and both non-zero and
within 1e-6 of zero (Adam's first step ``g / (|g| + eps)`` may part the
runs there); as a knock-on where its step-1 gradients are within the
rule and later ones are not, and a root of the same run feeds it (its
RWKV6 time-mix head, its table row). Each within ``steps x lr`` of the
strict tolerance. An element ZeRO-1's all-gather brought from another
data rank passes only equal bit for bit to that rank's copy
(`lm_mesh_mirror`). What the one-rank run keeps for it
(`lm_mesh_grad_store`): the small elements, the step-1 root candidates
and every element they feed.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_judge", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LR = 1e-4
HEAD_DIM = 64
BONUS = "blocks.1.tm.bonus_u"
GATE = "blocks.1.tm.g.w"
TABLE = "embed.table"
SHAPES = {BONUS: (40, HEAD_DIM), GATE: (2560, 2560), TABLE: (32, 8)}
FEEDS = {BONUS: ("head", "blocks.1.tm", 0, 1),
         GATE: ("head", "blocks.1.tm", 1, HEAD_DIM),
         TABLE: ("row", 8)}


def record(leaf, elements, *, kept=True, why=None):
    """`lm_mesh_readings`' record of `leaf` from ``[(whole flat index,
    this rank's gradient each step, one rank's, drift)]``: the one rank's
    parameter 0.5, this rank's 0.5 + drift."""
    whole = np.array([e[0] for e in elements])
    mine = np.array([e[1] for e in elements], float).T
    one = np.array([e[2] for e in elements], float).T
    want = np.full(len(elements), 0.5)
    return {"leaf": leaf, "whole": whole, "shape": SHAPES[leaf],
            "got": want + np.array([e[3] for e in elements]),
            "want": want, "kept": np.full(len(elements), kept),
            "mine": mine, "one": one, "why": why}


# the readings of PR 34's rwkv6-3b run at lr 1e-4 (`PERF.md` §6): the
# root bonus_u[264] (head 4), its knock-on bonus_u[287] (head 4)
ROOT = (264, [-1.8e-7, -6.78e-3, 1.1e-3], [-7.4e-7, -6.23e-3, 1.0e-3],
        1.5e-4)
KNOCK = (287, [-2.36550e-3, 2.62e-4, 1e-4], [-2.36579e-3, 5.06e-4, 2e-4],
         1e-4)
DRIFT = 1e-4   # past the strict 1e-5 + 1e-4 x 0.5, within 3 x lr more


def gate(column: int, row: int = 7) -> int:
    return row * SHAPES[GATE][1] + column


def test_a_root_passes(smoke):
    got = smoke.lm_mesh_verdicts([record(BONUS, [ROOT])], FEEDS, LR)
    assert got["failed"] == 0 and got["judged"] == 0
    assert got["roots"] == [(BONUS, 264, -1.8e-7, -7.4e-7)]


def test_a_knock_on_in_the_roots_head_passes(smoke):
    """bonus_u[287] and g.w column 297 (head 4, as rank 2's g.w[5089577]
    of PR 34) are fed by the root in head 4."""
    knock_g = (gate(297), [1e-3, 5e-4, 0.0], [1e-3, 9e-4, 0.0], DRIFT)
    got = smoke.lm_mesh_verdicts(
        [record(BONUS, [ROOT, KNOCK]), record(GATE, [knock_g])], FEEDS, LR)
    assert got["failed"] == 0
    assert got["knock_ons"] == [(BONUS, 287), (GATE, gate(297))]
    assert got["by_leaf"] == {BONUS: 2, GATE: 1}


def test_an_element_within_every_step_is_judged_as_before(smoke):
    ok = (gate(5), [2e-3, 1e-3, 3e-3], [2e-3, 1e-3, 3e-3], DRIFT)
    got = smoke.lm_mesh_verdicts([record(GATE, [ok])], FEEDS, LR)
    assert (got["judged"], got["failed"], got["roots"]) == (1, 0, [])


@pytest.mark.parametrize("case", ["other_head", "no_root", "not_kept",
                                  "drift", "step_one"])
def test_what_the_judge_fails(smoke, case):
    """A knock-on in another head (column 5, head 0), one with no root on
    the rank, one whose one-rank gradient was not kept, one whose drift
    is past ``steps x lr``, and an element whose step-1 gradients break
    the rule each fail; the root beside them still passes."""
    knock = (gate(297), [1e-3, 5e-4, 0.0], [1e-3, 9e-4, 0.0], DRIFT)
    records = [record(BONUS, [ROOT])]
    if case == "other_head":
        records.append(record(GATE, [(gate(5),) + knock[1:]]))
        reason = "no root feeding it"
    elif case == "no_root":
        records = [record(GATE, [knock])]
        reason = "no root feeding it"
    elif case == "not_kept":
        records.append(record(GATE, [knock], kept=False))
        reason = "not kept"
    elif case == "drift":
        records.append(record(GATE, [knock[:3] + (3 * LR + 2e-4,)]))
        reason = "drift past"
    else:
        records.append(record(GATE, [(gate(297), [1e-3, 5e-4, 0.0],
                                      [2e-3, 5e-4, 0.0], DRIFT)]))
        reason = "step-1 gradients apart"
    got = smoke.lm_mesh_verdicts(records, FEEDS, LR)
    assert got["failed"] == 1, got
    assert list(got["faults"]) == [GATE]
    assert reason in got["faults"][GATE][2][0]
    assert got["knock_ons"] == []
    assert len(got["roots"]) == (0 if case == "no_root" else 1)


@pytest.mark.parametrize("row, passes", [(3, True), (4, False)])
def test_a_table_root_feeds_its_row(smoke, row, passes):
    root = (3 * 8 + 1, [4.7e-8, -1.29583e-3, 0.0], [1.6e-8, -1.29299e-3, 0.0],
            1.2e-4)
    knock = (row * 8 + 6, [5e-3, 2e-3, 0.0], [5e-3, 1e-3, 0.0], DRIFT)
    got = smoke.lm_mesh_verdicts([record(TABLE, [root, knock])], FEEDS, LR)
    assert len(got["roots"]) == 1
    assert got["failed"] == (0 if passes else 1)
    assert got["knock_ons"] == ([(TABLE, row * 8 + 6)] if passes else [])


@pytest.mark.parametrize("first, passes", [
    ([-1.8e-7, -7.4e-7], True), ([1.5e-6, 0.8e-6], False)])
def test_a_candidate_kept_at_step_one_alone(smoke, first, passes):
    """A step-1 candidate that feeds itself alone keeps its step-1
    gradients only: it passes as a root, and fails where it is none (its
    later steps, which today's rule would read, were not kept)."""
    el = (264, [first[0], np.nan, np.nan], [first[1], np.nan, np.nan],
          1.5e-4)
    rec = record(GATE, [el])
    rec["first_only"] = np.array([True])
    got = smoke.lm_mesh_verdicts([rec], FEEDS, LR)
    assert got["failed"] == (0 if passes else 1)
    assert len(got["roots"]) == (1 if passes else 0)
    if not passes:
        assert "only its step-1 gradients kept" in got["faults"][GATE][2][0]


def test_a_root_must_be_near_zero_on_both_runs(smoke):
    """Step-1 gradients within the rule but one of them zero, or past
    1e-6: no root, so its later steps are held and it fails."""
    for first in ([0.0, -6.78e-3, 0.0], [-2.0e-6, -6.78e-3, 0.0]):
        el = (264, first, [first[0], -6.23e-3, 0.0], 1.5e-4)
        got = smoke.lm_mesh_verdicts([record(BONUS, [el])], FEEDS, LR)
        assert got["failed"] == 1 and got["roots"] == []


def test_an_all_gathered_copy_is_held_to_the_writing_rank(smoke):
    theirs = [("w", [5, 9], [1.0, 2.0])]
    assert smoke.lm_mesh_mirror(theirs, {("w", 5): 1.0, ("w", 9): 2.0}) \
        == (2, {})
    passed, faults = smoke.lm_mesh_mirror(
        theirs, {("w", 5): 1.0, ("w", 9): 2.0000002})
    assert passed == 1 and len(faults["w"]) == 1
    assert "w[9]" in faults["w"][0]
    passed, faults = smoke.lm_mesh_mirror(theirs, {("w", 5): 1.0})
    assert passed == 1 and "within the tolerance" in faults["w"][0]


def test_the_store_keeps_what_each_candidate_feeds(smoke):
    """A step-1 root candidate in head 2 of a time mix keeps head 2 of
    every leaf read by head; one in a table keeps its row; elsewhere the
    candidate alone, beside the small elements (`LoggedOptimizer`)."""
    shapes = {"tm.bonus_u": (4, 2), "tm.g.w": (6, 8), "embed.table": (5, 3),
              "w": (4, 4)}
    feeds = {"tm.bonus_u": ("head", "tm", 0, 1),
             "tm.g.w": ("head", "tm", 1, 2), "embed.table": ("row", 3)}
    steps = []
    for s in range(3):
        grads = {k: torch.full(v, 0.5 + s) for k, v in shapes.items()}
        steps.append(grads)
    steps[0]["tm.bonus_u"][2, 1] = 3e-7      # a candidate in head 2
    steps[0]["embed.table"][1, 0] = -2e-7    # a candidate in row 1
    steps[0]["w"][3, 3] = 1e-7
    steps[0]["w"][0, 0] = 0.0                # zero: no candidate
    small = [{k: torch.tensor([], dtype=torch.int64) for k in shapes}
             for _ in steps]
    small[1]["w"] = torch.tensor([6])
    store, (cands, kept) = smoke.lm_mesh_grad_store(
        torch, {"steps": steps, "small": small}, feeds)
    assert cands == 3
    every, first = store["all"], store["first"]
    idx, values = every["tm.g.w"]
    cols = sorted({int(i) % 8 for i in idx})
    assert cols == [4, 5] and len(idx) == 12     # head 2's columns
    assert values.shape == (3, 12)
    assert every["tm.bonus_u"][0].tolist() == [4, 5]
    assert every["embed.table"][0].tolist() == [3, 4, 5]
    # w's small element every step; its candidate, feeding itself
    # alone, at step 1 only (a root's later steps are not held)
    assert every["w"][0].tolist() == [6]
    assert first["w"][0].tolist() == [15]
    assert first["w"][1].tolist() == [[pytest.approx(1e-7)]]
    assert sorted(first) == ["w"]
    assert kept == 12 + 2 + 3 + 1 + 1
    whole = {k: torch.full(v, 1e-7) for k, v in shapes.items()}
    store, _ = smoke.lm_mesh_grad_store(
        torch, {"steps": [whole], "small": small[:1]}, feeds)
    assert store["first"]["w"][0] is None
    assert store["first"]["w"][1].shape == (1, 16)
    assert store["all"]["tm.g.w"][0] is None
    assert store["all"]["tm.g.w"][1].shape == (1, 48)


def test_the_feeds_follow_the_layers(smoke):
    from repro_torch.models import registry
    cfg = registry.get_config("rwkv6-3b-smoke")
    model = registry.build_model(cfg, "meta")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    feeds = smoke.lm_mesh_feeds(model, shapes)
    hd = model.blocks[0].tm.head_dim
    assert feeds["embed.table"] == ("row", cfg.d_model)
    assert feeds["blocks.1.tm.g.w"] == ("head", "blocks.1.tm", 1, hd)
    assert feeds["blocks.1.tm.o.w"] == ("head", "blocks.1.tm", 0, hd)
    assert feeds["blocks.0.tm.bonus_u"] == ("head", "blocks.0.tm", 0, 1)
    assert "blocks.0.tm.mix_a" not in feeds
    assert "blocks.0.cm.k.w" not in feeds
    keys = smoke.lm_mesh_feed_keys(
        "blocks.1.tm.g.w", np.array([3 * hd + 1, 5 * cfg.d_model + hd]),
        shapes["blocks.1.tm.g.w"], feeds)
    assert keys == [("head", "blocks.1.tm", 3), ("head", "blocks.1.tm", 1)]


def test_the_pipeline_judge_reads_float64(smoke, monkeypatch):
    """(c)'s judge (`lm_mesh_pipeline_judge`) on the CPU at smoke width: a
    gradient element past the rule passes where the fp32 one-rank stack
    is off the float64 stack by more than the rule and the pipeline's is
    no further, and fails where the pipeline's is further."""
    import dataclasses

    from repro_torch.models import registry
    cfg = dataclasses.replace(registry.get_config("qwen1.5-4b-smoke"),
                              compute_dtype="float32", kv_cache_dtype="")
    monkeypatch.setattr(smoke, "DEVICE", "cpu")
    monkeypatch.setattr(smoke, "LM_MESH_SEQ", 16)
    monkeypatch.setattr(smoke, "lm_mesh_config", lambda arch: cfg)
    stages = range(smoke.LM_MESH_STAGES)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        x, ct, blocks = smoke.lm_mesh_pipeline_inputs(torch, cfg, dtype,
                                                      stages)
        x.requires_grad_(True)
        h = x
        for blk in blocks.values():
            h = blk(h)[0]
        (h * ct).sum().backward()
        grads[dtype] = {"x": x.grad.reshape(-1).numpy(),
                        "1.attn.wq.w": blocks[1].attn.wq.w.grad
                        .reshape(-1).numpy()}
    misses = {}
    for k, want in grads[torch.float32].items():
        exact = grads[torch.float64][k]
        off = np.abs(want - exact)
        rule = 1e-6 + 1e-4 * np.abs(exact)
        at = np.nonzero(off > rule)[0][:2]
        assert len(at) == 2, k   # fp32 is off float64 past the rule there
        good = exact[at] + 0.5 * (want[at] - exact[at])
        bad = exact[at] + 3 * (want[at] - exact[at]) + 2 * rule[at]
        misses[k] = (np.concatenate([at, at]),
                     np.concatenate([good, bad]).astype(np.float32),
                     np.concatenate([want[at], want[at]]))
    got = smoke.lm_mesh_pipeline_judge(torch, misses)
    for k in misses:
        n, ok, faults = got[k]
        assert (n, ok, len(faults)) == (4, 2, 2), (k, got[k])
