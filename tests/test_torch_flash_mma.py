"""The arithmetic and the tile skipping of the flash_attention kernel, on
the CPU.

`flash_attention/flash_attention.cu` runs fp32 inputs as 3xTF32 on the
tensor cores: each operand x is split into hi = tf32(x) (`flash_mma.cuh`:
fp32 with its low 13 mantissa bits rounded away, ties away from zero)
and lo = x - hi, which the tensor core reads rounded toward zero to
TF32, and a product is lo*hi + hi*lo + hi*hi, three `mma.m16n8k8` per k
step of 8.  It visits only the kv tiles that
`kernel.tile_plan` lists, and applies the element mask only on the tiles
it marks.  The kernel cannot run here, so this file emulates it with
numpy: CTAs of row groups x kv splits (as the C entry chooses them), the
plan's kv tiles in order, dealt to the splits as the kernel deals them, each
mma as the exact sum of its 8 products added to the fp32 accumulator
with one rounding, in the kernel's k order, the online softmax update in
fp32 per kv tile, and the splits' merge in order.  The emulation is held
to the port's `attention_ref` and to the JAX Pallas kernel in interpret
mode within
the card's fp32 tolerance (rtol/atol 1e-5, chip_smoke.py's flash check),
at reduced versions of chip_smoke.py's three shapes: (a) graph attention
over sorted component ids with a padding id, (b) equal components plus
padding rows, 128 wide, (c) causal GQA with G = 5, 128 wide; at head
widths 20, 32 and 128.  Each case prints its margin (how far inside the
tolerance the worst element lies).

A hypothesis test holds `tile_plan` to brute force over random, unsorted
ids: no kv tile that holds an allowed pair is skipped, and a tile left
unmasked has every pair allowed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.flash_attention.kernel import (
    flash_attention as j_flash_attention)

from repro_torch.kernels.flash_attention.kernel import (BLOCK_K, CHUNK,
                                                        WARP_ROWS, tile_plan)
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = dict(rtol=1e-5, atol=1e-5)  # the fp32 kernel's on the card
MASKED = np.float32(-1e30)


def tf32(x: np.ndarray) -> np.ndarray:
    """fp32 -> TF32 as the kernel rounds: + half an ulp of TF32 on the
    bits, then the low 13 mantissa bits cleared (ties away from zero)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def toward_zero(x: np.ndarray) -> np.ndarray:
    """fp32 -> TF32 as the tensor core reads an operand: the low 13
    mantissa bits ignored."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple:
    """(hi, lo) as the tensor core sees them: hi = tf32(x), lo = x - hi
    (exact in fp32) rounded toward zero."""
    hi = tf32(x)
    return hi, toward_zero((x - hi).astype(np.float32))


def mma_3xtf32(acc: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """acc [.., M, N] += a [.., M, K] @ b [.., K, N] as the kernel: per k
    step of 8, three TF32 products (lo*hi, hi*lo, hi*hi), each the exact
    sum of its 8 products added to acc with one fp32 rounding (in fp64 by
    np.einsum's own loops, not a BLAS call)."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            acc = (acc.astype(np.float64) + np.einsum(
                "...mk,...kn->...mn", x[..., ks].astype(np.float64),
                y[..., ks, :].astype(np.float64))).astype(np.float32)
    return acc


def emulated_flash(q, k, v, q_seg, kv_seg, *, causal, rows, splits):
    """The fp32 kernel on numpy arrays q [B, Sq, H, D], k/v [B, Skv, K, D],
    segment ids [B, S] or None, with CTAs of rows x splits warps: q tiles
    of 16 rows x `rows`; in each pass over CHUNK kv tiles, split s of a
    row group takes the pass's visited tiles s, s + splits, ...; the
    splits merge in order at the end."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    width = -(-d // 8) * 8  # zero-padded to whole k steps, as the kernel
    block_q = WARP_ROWS * rows
    heads = np.arange(h) // (h // kh)  # each q head's kv head
    out = np.zeros(q.shape, np.float32)
    for bi in range(b):
        plan = tile_plan(None if q_seg is None else q_seg[bi].tolist(),
                         None if kv_seg is None else kv_seg[bi].tolist(),
                         sq, skv, causal, block_q)
        for qt, tiles in enumerate(plan):
            q0 = qt * block_q
            n = min(block_q, sq - q0)
            qs = np.zeros((h, block_q, width), np.float32)
            qs[:, :n, :d] = (q[bi, q0:q0 + n].transpose(1, 0, 2)
                             * np.float32(d ** -0.5))
            qi = q0 + np.arange(block_q)
            state = [(np.full((h, block_q), MASKED, np.float32),
                      np.zeros((h, block_q), np.float32),
                      np.zeros((h, block_q, width), np.float32))
                     for _ in range(splits)]
            by_pass = {}
            for tile in tiles:
                by_pass.setdefault(tile.index // CHUNK, []).append(tile)
            for pass_tiles in by_pass.values():
                for i, (tile, masked) in enumerate(pass_tiles):
                    m, l, acc = state[i % splits]
                    k0 = tile * BLOCK_K
                    nk = min(BLOCK_K, skv - k0)
                    ks = np.zeros((h, BLOCK_K, width), np.float32)
                    vs = np.zeros((h, BLOCK_K, width), np.float32)
                    ks[:, :nk, :d] = k[bi, k0:k0 + nk].transpose(1, 0,
                                                                 2)[heads]
                    vs[:, :nk, :d] = v[bi, k0:k0 + nk].transpose(1, 0,
                                                                 2)[heads]
                    s = mma_3xtf32(np.zeros((h, block_q, BLOCK_K),
                                            np.float32), qs,
                                   ks.transpose(0, 2, 1))
                    if masked:
                        kj = k0 + np.arange(BLOCK_K)
                        ok = np.broadcast_to(kj[None] < skv,
                                             (block_q, BLOCK_K))
                        if causal:
                            ok = ok & (kj[None] <= qi[:, None])
                        if q_seg is not None:
                            qid = np.where(qi < sq, q_seg[bi][np.minimum(
                                qi, sq - 1)], np.iinfo(np.int32).min)
                            kid = kv_seg[bi][np.minimum(kj, skv - 1)]
                            ok = ok & (qid[:, None] == kid[None])
                        s = np.where(ok[None], s, MASKED)
                    m_new = np.maximum(m, s.max(-1))
                    p = np.exp(s - m_new[..., None]).astype(np.float32)
                    if masked:
                        p = np.where(s == MASKED, np.float32(0), p)
                    alpha = np.exp(m - m_new).astype(np.float32)
                    l = (l * alpha + p.sum(-1, dtype=np.float32)).astype(
                        np.float32)
                    acc = mma_3xtf32((acc * alpha[..., None]).astype(
                        np.float32), p, vs)
                    state[i % splits] = (m_new, l, acc)
            m = np.max([st[0] for st in state], axis=0)
            l = np.zeros_like(m)
            acc = np.zeros_like(state[0][2])
            for m_s, l_s, acc_s in state:  # the merge, in split order
                w = np.exp(m_s - m).astype(np.float32)
                l = (l + l_s * w).astype(np.float32)
                acc = (acc + acc_s * w[..., None]).astype(np.float32)
            res = acc / np.maximum(l, np.float32(1e-30))[..., None]
            out[bi, q0:q0 + n] = res[:, :n, :d].transpose(1, 0, 2)
    return out


def components(rng, n, n_comp, padding):
    """Sorted component ids of random sizes over n rows, the last
    `padding` rows on the padding id n_comp (as `component_ids()`)."""
    cuts = np.sort(rng.choice(np.arange(1, n - padding), n_comp - 1,
                              replace=False))
    sizes = np.diff(np.concatenate([[0], cuts, [n - padding]]))
    return np.concatenate([np.repeat(np.arange(n_comp), sizes),
                           np.full(padding, n_comp)]).astype(np.int32)


def case(name):
    """(q, k, v, segments or None, causal), fp32 unit normals from a seed:
    reduced (a), (a) at width 20, (b) and (c)."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def qkv(s, h, kh, d):
        return tuple(rng.standard_normal((1, s, n, d)).astype(np.float32)
                     for n in (h, kh, kh))

    if name in ("a", "a20"):
        d = 32 if name == "a" else 20
        return (*qkv(320, 4, 4, d), components(rng, 320, 16, 20)[None],
                False)
    if name == "b":
        seg = np.minimum(np.arange(384) // 60, 6).astype(np.int32)[None]
        return (*qkv(384, 4, 4, 128), seg, False)
    return (*qkv(256, 10, 2, 128), None, True)


def margin(got, want) -> float:
    """How far inside rtol/atol 1e-5 the worst element lies (> 1: within)."""
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return float(1 / (err / (TOL["atol"] + TOL["rtol"] * np.abs(want))).max())


@pytest.mark.parametrize("cta", [(4, 1), (1, 4)])
@pytest.mark.parametrize("name", ["a", "a20", "b", "c"])
def test_emulated_3xtf32_kernel_meets_the_fp32_rule(name, cta):
    """The emulated kernel against attention_ref and the JAX Pallas kernel
    (interpret mode), rtol/atol 1e-5, with CTAs of 4 row groups (one warp
    walks each row's kv tiles, as at (b) and (c) on the card) and of 4 kv
    splits merged at the end (as the small grid of (a) gets)."""
    q, k, v, seg, causal = case(name)
    rows, splits = cta
    got = emulated_flash(q, k, v, seg, seg, causal=causal, rows=rows,
                         splits=splits)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    tseg = None if seg is None else torch.from_numpy(seg)
    plain = attention_ref(*t, tseg, tseg, causal=causal).numpy()
    jseg = None if seg is None else jnp.asarray(seg)
    pallas = np.asarray(j_flash_attention(
        *map(jnp.asarray, (q, k, v)), jseg, jseg, causal=causal, q_block=64,
        kv_block=64, interpret=True))
    for ref_name, want in (("attention_ref", plain),
                           ("pallas-interpret", pallas)):
        print(f"({name}, CTA {rows} x {splits}) emulated 3xTF32 vs "
              f"{ref_name}: max err {np.abs(got - want).max():.2e}, margin "
              f"{margin(got, want):.1f}x")
        np.testing.assert_allclose(got, want, **TOL)


def test_tf32_split_rounds_to_nearest_ties_away():
    """tf32() keeps 10 mantissa bits, rounds half an ulp away from zero,
    and hi + lo carries x to within 2^-21 of it."""
    one_ulp = np.float32(2.0 ** -10)
    half = np.float32(2.0 ** -11)
    x = np.array([1 + half, -(1 + half), 1 + half / 2, 3.0], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([1 + one_ulp, -(1 + one_ulp), 1, 3], np.float32))
    y = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    hi, lo = split(y)
    assert np.all(tf32(hi) == hi) and np.all(tf32(lo) == lo)
    assert np.all(np.abs(hi.astype(np.float64) + lo - y)
                  <= 2.0 ** -21 * np.abs(y))


@st.composite
def plan_inputs(draw):
    causal = draw(st.booleans())
    sq = draw(st.integers(1, 150))
    skv = sq if causal else draw(st.integers(1, 150))
    segmented = draw(st.booleans())
    ids = st.integers(0, 4)
    q_ids = kv_ids = None
    if segmented:
        q_ids = draw(st.lists(st.one_of(ids, st.just(9)), min_size=sq,
                              max_size=sq))  # 9: an id no key has
        kv_ids = draw(st.lists(ids, min_size=skv, max_size=skv))
    block_q = draw(st.sampled_from([16, 32, 64]))
    return q_ids, kv_ids, sq, skv, causal, block_q


@settings(max_examples=300, deadline=None)
@given(plan_inputs())
def test_tile_plan_never_skips_an_allowed_pair(args):
    """Brute force over every (q tile, kv tile): a tile holding a pair the
    mask allows is visited; a visited tile left unmasked is full and has
    every pair allowed; the visited tiles of each q tile come in order."""
    q_ids, kv_ids, sq, skv, causal, block_q = args
    plan = tile_plan(q_ids, kv_ids, sq, skv, causal, block_q)
    assert len(plan) == -(-sq // block_q)
    qa = None if q_ids is None else np.array(q_ids)
    ka = None if kv_ids is None else np.array(kv_ids)
    for qt, tiles in enumerate(plan):
        assert [t.index for t in tiles] == sorted({t.index for t in tiles})
        visited = {t.index: t.masked for t in tiles}
        qi = np.arange(qt * block_q, min((qt + 1) * block_q, sq))
        for tile in range(-(-skv // BLOCK_K)):
            kj = np.arange(tile * BLOCK_K, min((tile + 1) * BLOCK_K, skv))
            allowed = np.ones((qi.size, kj.size), bool)
            if causal:
                allowed &= kj[None] <= qi[:, None]
            if qa is not None:
                allowed &= qa[qi][:, None] == ka[kj][None]
            if allowed.any():
                assert tile in visited, (qt, tile)
            if tile in visited and not visited[tile]:
                assert kj.size == BLOCK_K and allowed.all(), (qt, tile)
