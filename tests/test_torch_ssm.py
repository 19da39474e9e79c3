"""The port's state-space cells (`repro_torch.nn.ssm`: `Mamba2`,
`RWKV6TimeMix`, `RWKV6ChannelMix`) against the JAX package's, on the CPU.

Parameters are the reference's ``split_params(init(PRNGKey(0)))[0]``
carried across with `load_jax_params`, every leaf perturbed by seeded
noise; inputs and non-zero states come from a numpy seed.

* The chunked form at S = 32, 12 and 13, from zero states and from
  non-zero ones, at the cells' own chunk (Mamba2 128: one chunk; RWKV6
  16: two chunks at 32) and at chunk 8 (Mamba2 and RWKV6: 4 chunks at
  32, 2 of 6 at 12, and at the prime 13 the reference's rule lowers the
  chunk to 1, so 13 chunks of one step).  Outputs and both states.
* `decode_step` chains of 5 steps after a chunked prefill, and the
  chunked form against the chained steps over the same tokens.
* RWKV6's decay clip at both ends (`dec_base` pushed past 1.609 and
  below -20) and its LayerNorm over all of d.
* bf16 compute (fp32 states).
* `init_params`: the reference's constants.

Tolerances: fp32 rtol 1e-5 / atol 1e-5 throughout, the chunked scans
included (the looser 1e-4 allowed for them is not needed); bf16 outputs
2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssm as j_ssm

from repro_torch.nn import layers as t_layers
from repro_torch.nn import ssm as t_ssm
from test_torch_lm import TOL, both, close, jax_tree, normal

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
D = 64


def pair(ref, mod, noise=0.05):
    tree = jax_tree(ref, noise=noise)
    t_layers.load_jax_params(mod, tree)
    return ref, mod, tree


def mamba_pair(chunk=128):
    kw = dict(d_state=16, head_dim=16, chunk=chunk)
    return pair(j_ssm.Mamba2(D, **kw), t_ssm.Mamba2(D, **kw))


def rwkv_pair(chunk=16):
    kw = dict(head_dim=16, chunk=chunk)
    return pair(j_ssm.RWKV6TimeMix(D, **kw), t_ssm.RWKV6TimeMix(D, **kw))


def mamba_state(mod, b, zero, seed=0):
    ssm = (mod.n_heads, mod.head_dim, mod.d_state)
    conv = (mod.conv_kernel - 1, mod.conv_dim)
    s = normal((b,) + ssm, seed, 0.5) * (not zero)
    c = normal((b,) + conv, seed + 1) * (not zero)
    return (j_ssm.Mamba2State(jnp.asarray(s), jnp.asarray(c)),
            t_ssm.Mamba2State(torch.from_numpy(s), torch.from_numpy(c)))


def rwkv_state(mod, b, zero, seed=0):
    shift = normal((b, D), seed) * (not zero)
    wkv = normal((b, mod.n_heads, mod.head_dim, mod.head_dim), seed + 1,
                 0.3) * (not zero)
    return both(shift), both(wkv)


def close_state(got, want, tol):
    for g, w in zip(got, want):
        close(g, w, **tol)


@pytest.mark.parametrize("chunk", [128, 8])
@pytest.mark.parametrize("seq", [32, 12, 13])
@pytest.mark.parametrize("zero", [True, False])
def test_mamba2_chunked_matches_reference(chunk, seq, zero):
    ref, mod, tree = mamba_pair(chunk)
    jx, tx = both(normal((2, seq, D), 10))
    jst, tst = mamba_state(mod, 2, zero)
    want, wstate = ref(tree, jx, jst)
    with torch.no_grad():
        got, gstate = mod(tx, tst)
    close(got, want, **TOL)
    close_state(gstate, wstate, TOL)


@pytest.mark.parametrize("chunk", [16, 8])
@pytest.mark.parametrize("seq", [32, 12, 13])
@pytest.mark.parametrize("zero", [True, False])
def test_rwkv6_time_mix_chunked_matches_reference(chunk, seq, zero):
    ref, mod, tree = rwkv_pair(chunk)
    jx, tx = both(normal((2, seq, D), 11))
    (js, ts), (jw, tw) = rwkv_state(mod, 2, zero)
    want = ref(tree, jx, js, jw)
    with torch.no_grad():
        got = mod(tx, ts, tw)
    close_state(got, want, TOL)


@pytest.mark.parametrize("chunk,seq,want", [
    (128, 13, 13), (16, 13, 13), (16, 32, 16), (8, 12, 6), (8, 13, 1),
    (16, 17, 1), (16, 2048, 16), (128, 2048, 128), (16, 12, 12)])
def test_chunk_length_is_the_reference_rule(chunk, seq, want):
    assert t_ssm.chunk_length(chunk, seq) == want


def test_mamba2_decode_chain_matches_reference():
    ref, mod, tree = mamba_pair(chunk=8)
    xs = normal((2, 21, D), 12)
    jx, tx = both(xs[:, :16])
    _, jst = ref(tree, jx)
    with torch.no_grad():
        _, tst = mod(tx)
    for t in range(16, 21):
        jx, tx = both(xs[:, t:t + 1])
        want, jst = ref.decode_step(tree, jx, jst)
        with torch.no_grad():
            got, tst = mod.decode_step(tx, tst)
        close(got, want, **TOL)
        close_state(tst, jst, TOL)
    # the chunked form over all 21 tokens ends in the chained state
    with torch.no_grad():
        _, full = mod(torch.from_numpy(xs))
    close_state(full, tst, TOL)


def test_rwkv6_decode_chain_matches_reference():
    ref, mod, tree = rwkv_pair()
    xs = normal((2, 21, D), 13)
    (js, ts), (jw, tw) = rwkv_state(mod, 2, True)
    jx, tx = both(xs[:, :16])
    _, js, jw = ref(tree, jx, js, jw)
    with torch.no_grad():
        _, ts, tw = mod(tx, ts, tw)
    outs = []
    for t in range(16, 21):
        jx, tx = both(xs[:, t:t + 1])
        want, js, jw = ref.decode_step(tree, jx, js, jw)
        with torch.no_grad():
            got, ts, tw = mod.decode_step(tx, ts, tw)
        close(got, want, **TOL)
        close_state((ts, tw), (js, jw), TOL)
        outs.append(got)
    with torch.no_grad():
        full, fs, fw = mod(torch.from_numpy(xs),
                           *(torch.zeros_like(a) for a in (ts, tw)))
    close(full[:, 16:], torch.cat(outs, 1), **TOL)
    close_state((fs, fw), (ts, tw), TOL)


@pytest.mark.parametrize("base", [4.0, -30.0, "both"])
def test_rwkv6_decay_clip_at_both_ends(base):
    """dec_base past either end of [-20, 1.609]: the log-decay sits at
    -exp(1.609) ~ -5 or -exp(-20) ~ -2e-9 for every channel (half of each
    with "both"), in both packages, and the chunked form stays finite."""
    ref, mod, tree = rwkv_pair()
    values = (np.where(np.arange(D) % 2, 4.0, -30.0) if base == "both"
              else np.full(D, base))
    tree["dec_base"] = values.astype(np.float32)
    t_layers.load_jax_params(mod, tree)
    jx, tx = both(normal((2, 32, D), 14))
    with torch.no_grad():
        logw = mod._decay(tx)
    close(logw, ref._decay(tree, jx), **TOL)
    lo, hi = -np.exp(1.609), -np.exp(-20.0)
    assert logw.min().item() >= lo * (1 + 1e-6)
    assert logw.max().item() <= hi * (1 - 1e-6)
    (js, ts), (jw, tw) = rwkv_state(mod, 2, False)
    with torch.no_grad():
        got = mod(tx, ts, tw)
    assert all(torch.isfinite(g).all() for g in got)
    close_state(got, ref(tree, jx, js, jw), TOL)


def test_rwkv6_out_normalises_over_all_of_d():
    """One LayerNorm over d (not a group norm a head): scaling one head's
    wkv output moves the others' normalised values."""
    _, mod, _ = rwkv_pair()
    y = torch.from_numpy(normal((1, 3, mod.n_heads, mod.head_dim), 15))
    g = torch.ones(1, 3, D)
    with torch.no_grad():
        base = mod.ln_x(y.reshape(1, 3, D))
        y2 = y.clone()
        y2[:, :, 0] *= 10
        moved = mod.ln_x(y2.reshape(1, 3, D))
        assert torch.equal(mod._out(y, g, 1, 3), mod.o(base))
    assert not torch.allclose(base[..., 16:], moved[..., 16:])


def test_rwkv6_channel_mix_matches_reference():
    ref, mod, tree = pair(j_ssm.RWKV6ChannelMix(D, 96),
                          t_ssm.RWKV6ChannelMix(D, 96))
    jx, tx = both(normal((2, 9, D), 16))
    js, ts = both(normal((2, D), 17))
    with torch.no_grad():
        got = mod(tx, ts)
    close_state(got, ref(tree, jx, js), TOL)


@pytest.mark.parametrize("cell", ["mamba2", "rwkv6"])
def test_cells_in_bf16_match_reference(cell):
    jx, tx = both(normal((2, 16, D), 18), "bfloat16")
    if cell == "mamba2":
        ref, mod, tree = mamba_pair(chunk=8)
        want, wstate = ref(tree, jx)
        with torch.no_grad():
            got, gstate = mod(tx)
        states = (gstate, wstate)
    else:
        ref, mod, tree = rwkv_pair()
        (js, ts), (jw, tw) = rwkv_state(mod, 2, True)
        want, _, wstate = ref(tree, jx, js.astype(jnp.bfloat16), jw)
        with torch.no_grad():
            got, _, gstate = mod(tx, ts.to(torch.bfloat16), tw)
        states = ((gstate,), (wstate,))
    assert got.dtype == torch.bfloat16
    close(got, want, **BF16_TOL)
    for g, w in zip(*states):
        assert g.dtype == torch.float32  # the recurrences stay fp32
        close(g, w, **BF16_TOL)


def test_init_params_draws_the_reference_constants():
    kw = dict(d_state=16, head_dim=16)
    mod = t_layers.init_params(t_ssm.Mamba2(D, **kw), 0)
    want = jax_tree(j_ssm.Mamba2(D, **kw))
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        close(getattr(mod, name), want[name], rtol=1e-6, atol=1e-7)
    assert abs(mod.conv_w.std().item() - 0.1) < 0.02
    assert torch.equal(mod.norm.scale, torch.ones(mod.d_inner))

    tm = t_layers.init_params(t_ssm.RWKV6TimeMix(D, head_dim=16), 0)
    want = jax_tree(j_ssm.RWKV6TimeMix(D, head_dim=16))
    for name in ("mu_x", "mu", "bonus_u", "dec_base"):
        close(getattr(tm, name), want[name], rtol=1e-6, atol=1e-7)
    for name in ("mix_a", "mix_b", "dec_a", "dec_b"):
        assert abs(getattr(tm, name).std().item() - 0.02) < 0.004, name
    assert tm.r.w.abs().max() > 0

    cm = t_layers.init_params(t_ssm.RWKV6ChannelMix(D, 96), 0)
    want = jax_tree(j_ssm.RWKV6ChannelMix(D, 96))
    for name in ("mu_k", "mu_r"):
        close(getattr(cm, name), want[name], rtol=0, atol=0)
    for m, r in ((mod, j_ssm.Mamba2(D, **kw)),
                 (tm, j_ssm.RWKV6TimeMix(D, head_dim=16)),
                 (cm, j_ssm.RWKV6ChannelMix(D, 96))):
        ref = t_layers._flatten_tree(jax_tree(r))
        assert {k: tuple(p.shape) for k, p in m.named_parameters()} == \
            {k: v.shape for k, v in ref.items()}
