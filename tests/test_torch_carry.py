"""The fixed-order fold of the sorted-run kernels (`kernels/carry.cuh`),
mirrored in plain Python and checked on the CPU.

The CUDA kernels run only on the card; this file keeps their carry rule
testable here, as `flash_attention/kernel.tile_plan` does for the flash
kernel's skip rule.  The mirrors follow the sources step for step:

* `pool_pieces`: `segment_pool_runs`' run kernels (runs.cu): a warp folds
  each run of its piece (16-row tiles, or 32-row warps below D 32) and at
  each run end adds it, or stores it to the piece's head or tail slot
  when it crosses the piece's boundary (`carry_slot`, `carry_meta`);
* `edge_pieces`: `edge_mpnn_runs`' epilogue (edge_mpnn_runs.cu): four
  walkers a column over the quarters of a 32- or 64-edge tile, whose
  boundary runs the column's first walker joins in quarter order;
* `fold`: `carry_fold_kernel`, one chain from each tail slot through the
  head slots that pass through.

Properties, over seeded and hypothesis-drawn id vectors: on integer
messages every mirror gives the exact segment sums for any id order; on
sorted ids every valid segment receives exactly one add (a run's own, or
its chain's) — the reason the card's fp32 sums repeat bit for bit.
"""
from collections import Counter

import numpy as np
import pytest

try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:  # the seeded sweeps below still run
    hypothesis = None

HEAD, TAIL, ADD = 0, 1, -1


def carry_slot(first_run, last_run, from_prev, into_next):
    if first_run and from_prev:
        return HEAD
    if last_run and into_next:
        return TAIL
    return ADD


def carry_meta(first_id, last_id, one_run, from_prev, into_next):
    """(head id, tail id, through), as carry.cuh's int4."""
    through = from_prev and one_run and into_next
    return (first_id if from_prev else -1,
            last_id if into_next and not (from_prev and one_run) else -1,
            through)


class Out:
    """The accumulator, the scratch slots and the record of adds."""

    def __init__(self, n, pieces):
        self.acc = np.zeros(n, np.int64)
        self.parts = [[None, None] for _ in range(pieces)]
        self.meta = [None] * pieces
        self.adds = Counter()

    def add(self, seg, value):
        self.acc[seg] += value
        self.adds[seg] += 1


def neighbours(ids, start, rows, n):
    """(ids of the piece with -1 past E and for ids outside [0, n), the
    id before the piece, the id after it, the piece's last valid row)."""
    e = len(ids)

    def valid(i):
        return ids[i] if 0 <= ids[i] < n else -1

    piece = [valid(i) if i < e else -1 for i in range(start, start + rows)]
    before = valid(start - 1) if start > 0 else -1
    after = valid(start + rows) if start + rows < e else -1
    return piece, before, after, min(rows, e - start) - 1


def pool_pieces(ids, values, n, rows):
    """runs.cu: each piece of `rows` rows folds its runs in row order."""
    e = len(ids)
    pieces = -(-e // rows)
    out = Out(n, pieces)
    for p in range(pieces):
        dst, before, after, last = neighbours(ids, p * rows, rows, n)
        vals = [values[i] if i < e else 0 for i in range(p * rows,
                                                         p * rows + rows)]
        from_prev = dst[0] >= 0 and before == dst[0]
        into_next = dst[last] >= 0 and after == dst[last]
        run, first_end = 0, -1
        for r in range(rows):
            run += vals[r]
            if r + 1 == rows or dst[r + 1] != dst[r]:
                if dst[r] >= 0:
                    slot = carry_slot(first_end < 0, r == last, from_prev,
                                      into_next)
                    if slot == ADD:
                        out.add(dst[r], run)
                    else:
                        out.parts[p][slot] = run
                if first_end < 0:
                    first_end = r
                run = 0
        out.meta[p] = carry_meta(dst[0], dst[last], first_end >= last,
                                 from_prev, into_next)
    return out


def edge_pieces(ids, msgs, n, rows, walkers=4):
    """edge_mpnn_runs.cu's epilogue: quarter walkers, then their join."""
    e = len(ids)
    pieces = -(-e // rows)
    out = Out(n, pieces)
    quarter = rows // walkers
    for p in range(pieces):
        dst, before, after, last = neighbours(ids, p * rows, rows, n)
        msg = [msgs[i] if i < e else 0 for i in range(p * rows,
                                                      p * rows + rows)]
        heads, tails = [], []
        for w in range(walkers):
            r0, first, run, in_first = w * quarter, 0, 0, True
            for k in range(quarter):
                run += msg[r0 + k]
                if k + 1 < quarter and dst[r0 + k + 1] != dst[r0 + k]:
                    if in_first:
                        first = run
                    elif dst[r0 + k] >= 0:
                        out.add(dst[r0 + k], run)
                    in_first, run = False, 0
            heads.append(first)
            tails.append(run)
        from_prev = dst[0] >= 0 and before == dst[0]
        into_next = dst[last] >= 0 and after == dst[last]

        def emit(total, seg, first_run, last_run):
            if seg < 0:
                return
            slot = carry_slot(first_run, last_run, from_prev, into_next)
            if slot == ADD:
                out.add(seg, total)
            else:
                out.parts[p][slot] = total

        cur, cur_id, cur_first, split = 0, -1, False, False
        for w in range(walkers):
            s0 = w * quarter
            one = all(dst[s0 + k + 1] == dst[s0 + k]
                      for k in range(quarter - 1))
            head_id = dst[s0]
            if w > 0 and head_id == cur_id:
                if one:
                    cur += tails[w]
                    continue
                emit(cur + heads[w], cur_id, cur_first, False)
            else:
                if w > 0:
                    emit(cur, cur_id, cur_first, False)
                    split = True
                if one:
                    cur, cur_id, cur_first = tails[w], head_id, w == 0
                    continue
                emit(heads[w], head_id, w == 0, False)
            split = True
            cur, cur_id, cur_first = tails[w], dst[s0 + quarter - 1], False
        emit(cur, cur_id, cur_first, True)
        out.meta[p] = carry_meta(dst[0], dst[last], not split, from_prev,
                                 into_next)
    return out


def fold(out):
    """carry_fold_kernel: each tail slot's chain, added once."""
    pieces = len(out.meta)
    for p in range(pieces):
        seg = out.meta[p][1]
        if seg < 0:
            continue
        last = p + 1
        while last < pieces and out.meta[last][2]:
            last += 1
        assert out.meta[p + 1][0] == seg  # the chain goes on at p + 1
        out.add(seg, out.parts[p][TAIL] + sum(
            out.parts[u][HEAD] for u in range(p + 1, last + 1)))
    return out


def segment_sums(ids, values, n):
    want = np.zeros(n, np.int64)
    for i, v in zip(ids, values):
        if 0 <= i < n:
            want[i] += v
    return want


MIRRORS = {"pool tile": (pool_pieces, 16), "pool warp": (pool_pieces, 32),
           "edge fp32": (edge_pieces, 32), "edge 16-bit": (edge_pieces, 64)}


def check(ids, n, seed, sort):
    rng = np.random.default_rng(seed)
    values = rng.integers(-8, 8, len(ids))
    for name, (mirror, rows) in MIRRORS.items():
        out = fold(mirror(list(ids), list(values), n, rows))
        np.testing.assert_array_equal(out.acc, segment_sums(ids, values, n),
                                      err_msg=name)
        if sort:
            assert all(c == 1 for c in out.adds.values()), (name, out.adds)
            assert set(out.adds) == {i for i in ids if 0 <= i < n}, name


def sorted_ids(lengths, n_pad):
    """Runs of the given lengths with ids 0, 2, 4, ... (odd ids empty),
    then padding rows with id n."""
    n = 2 * len(lengths)
    ids = np.repeat(np.arange(0, n, 2), lengths)
    return np.concatenate([ids, np.full(n_pad, n)]).astype(int), n


@pytest.mark.parametrize("case", range(24))
def test_sorted_ids_get_one_add_a_segment(case):
    rng = np.random.default_rng(case)
    top = (2, 20, 200)[case % 3]
    lengths = rng.integers(1, top + 1, int(rng.integers(1, 12)))
    ids, n = sorted_ids(lengths, int(rng.integers(0, 40)))
    check(ids, n, case, sort=True)


@pytest.mark.parametrize("case", range(12))
def test_any_order_gives_the_exact_sums(case):
    rng = np.random.default_rng(100 + case)
    e = int(rng.integers(1, 300))
    n = int(rng.integers(1, 20))
    ids = rng.integers(-2, n + 3, e)  # out-of-range ids add nothing
    if case % 2:  # runs broken up: repeated ids, not sorted
        ids = np.repeat(ids[: e // 5 + 1], 5)[:e]
    check(ids, n, case, sort=False)


def test_the_trained_shape_one_long_run():
    """The trained batch's shape: 1051 short runs, then 2697 rows into one
    valid id, across 85 edge tiles and 169 pool tiles."""
    rng = np.random.default_rng(7)
    short = 1 + np.bincount(rng.integers(0, 1051, 2478 - 1051),
                            minlength=1051)
    rows = np.sort(rng.permutation(1408)[:1051])
    ids = np.concatenate([np.repeat(rows, short), np.full(2697, 1408)])
    check(ids, 1409, 7, sort=True)


if hypothesis is not None:
    @hypothesis.given(st.lists(st.integers(1, 300), min_size=1,
                               max_size=8), st.integers(0, 40),
                      st.integers(0, 2 ** 16))
    @hypothesis.settings(max_examples=40, deadline=None)
    def test_sorted_runs_fuzzed(lengths, n_pad, seed):
        ids, n = sorted_ids(lengths, n_pad)
        check(ids, n, seed, sort=True)
