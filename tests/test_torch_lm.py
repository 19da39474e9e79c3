"""The port's dense LM stack against the JAX package, on the CPU.

Inputs come from a numpy seed; weights are the reference's
``split_params(module.init(PRNGKey(0)))[0]`` carried across with
`load_jax_params` / `load_jax_lm_params` (for single layers, every leaf
is perturbed by seeded noise first, so zero-initialised biases and unit
norm scales are exercised too).

* Layers: `RMSNorm`, `MLP` (gated and plain, every activation; gelu is
  the tanh form), `Embedding` (its lookup in the compute dtype) and its
  tied head `attend`, `Dropout`, `apply_rope` and `rope_frequencies`,
  `sinusoidal_positions`, `gqa_attention` with causal and length masks
  (and its h // G head map), `chunked_gqa_attention`, `Attention`
  forward / decode_step / cross_decode_step with GQA 4:2 and QKV bias,
  and the `use_flash` route against the reference run through the
  Pallas kernel in interpret mode.
* The cache: `KVCache.update` against `dynamic_update_slice`, its clamp
  included, and the float8_e4m3fn cast against `jnp.astype` at the
  overflow boundary (NaN past 464, where torch alone saturates).
* Whole models: `DecoderLM` forward, prefill (logits and cache) and
  decode for five smoke configs (sequential and parallel blocks,
  RMSNorm and LayerNorm, tied and untied heads, patch embeddings), one
  forward at 1024 tokens through the chunked path, fp32 logits from a
  bf16 model.
* The registry: every config and its `-smoke` equal to the reference's,
  parameter counts of every arch (smoke configs built, full sizes on the
  meta device), runnable cells, an unknown family refused; the weight
  carry's refusals; `build_model` needs a card unless given
  ``device="cpu"``.  The other families' models are held to the
  reference in `test_torch_lm_families.py`.

Tolerances: fp32 rtol 1e-5 / atol 1e-5 unless a test states another;
bf16 outputs 2e-2 (a bf16 ulp at the outputs' scale).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as J_SHAPES
from repro.models import registry as j_registry
from repro.nn import attention as j_attn
from repro.nn import layers as j_layers
from repro.nn.module import param_count, split_params

from repro_torch.configs.base import SHAPES
from repro_torch.models import registry
from repro_torch.nn import attention as t_attn
from repro_torch.nn import layers as t_layers

TOL = dict(rtol=1e-5, atol=1e-5)
DENSE_ARCHS = ["qwen1.5-4b", "qwen2.5-32b", "deepseek-7b",
               "command-r-plus-104b", "phi-3-vision-4.2b"]


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(to_np(got), to_np(want), **(tol or TOL))


def jax_tree(module, seed=0, noise=None):
    """The reference's initial parameters as numpy; with `noise`, every
    leaf plus seeded normal noise of that scale."""
    tree = jax.tree_util.tree_map(
        np.asarray, split_params(module.init(jax.random.PRNGKey(seed)))[0])
    if noise is not None:
        rng = np.random.default_rng(seed + 1)
        tree = jax.tree_util.tree_map(
            lambda a: (a + noise * rng.standard_normal(a.shape))
            .astype(np.float32), tree)
    return tree


def normal(shape, seed=0, scale=1.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def both(a: np.ndarray, dtype="float32"):
    """The same array in both packages, rounded to `dtype` once."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(norm, dtype):
    ref = (j_layers.RMSNorm(48) if norm == "rmsnorm"
           else j_layers.LayerNorm(48))
    mod = (t_layers.RMSNorm(48) if norm == "rmsnorm"
           else t_layers.LayerNorm(48))
    tree = jax_tree(ref, noise=0.3)
    t_layers.load_jax_params(mod, tree)
    jx, tx = both(normal((3, 5, 48), 2, 2.0), dtype)
    got = mod(tx)
    assert got.dtype == tx.dtype  # cast back to the input dtype
    close(got, ref(tree, jx),
          **(TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)))


@pytest.mark.parametrize("activation", sorted(t_layers.ACTIVATIONS))
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_reference(activation, gated):
    ref = j_layers.MLP(32, 80, activation=activation, gated=gated)
    mod = t_layers.MLP(32, 80, activation=activation, gated=gated)
    tree = jax_tree(ref)
    t_layers.load_jax_params(mod, tree)
    assert (mod.wg is None) == (not gated)
    jx, tx = both(normal((2, 7, 32), 3))
    close(mod(tx), ref(tree, jx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_lookup_and_tied_head(dtype):
    ref = j_layers.Embedding(64, 24)
    mod = t_layers.Embedding(64, 24)
    tree = jax_tree(ref)
    t_layers.load_jax_params(mod, tree)
    ids = np.random.default_rng(4).integers(0, 64, (3, 9))
    got = mod(torch.from_numpy(ids), dtype=getattr(torch, dtype))
    want = ref(tree, jnp.asarray(ids), dtype=getattr(jnp, dtype))
    assert got.dtype == getattr(torch, dtype)  # the compute dtype
    close(got, want, rtol=0, atol=0)
    jx, tx = both(normal((3, 9, 24), 5), dtype)
    logits = mod.attend(tx)
    assert logits.dtype == tx.dtype
    close(logits, ref.attend(tree, jx),
          **(TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)))


def test_dropout_rule():
    x = torch.ones(4000)
    drop = t_layers.Dropout(0.25)
    assert drop(x) is x and t_layers.Dropout(0.0)(x, torch.Generator()) is x
    y = drop(x, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    again = drop(x, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)


@pytest.mark.parametrize("head_dim,theta,max_pos,atol", [
    (32, 10000.0, 64, 1e-5),
    (64, 1e6, 512, 1e-5),
    # positions in the thousands: torch's and XLA's fp32 power differ by
    # an ulp at (128, 1e6), which moves an angle at position p by about
    # p * 6e-8 (1.2e-4 at 2048); the outputs are of unit scale
    (128, 1e6, 2048, 5e-4),
    (128, 7.5e7, 2048, 5e-4),
])
def test_rope_matches_reference(head_dim, theta, max_pos, atol):
    x = normal((2, 6, 3, head_dim), 6)
    pos = np.random.default_rng(7).integers(0, max_pos, (2, 6))
    got = t_attn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta)
    want = j_attn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    close(got, want, rtol=1e-5, atol=atol)
    close(t_attn.rope_frequencies(head_dim, theta),
          j_attn.rope_frequencies(head_dim, theta), rtol=1e-6, atol=0)


def test_rope_keeps_bf16():
    jx, tx = both(normal((1, 4, 2, 16), 8), "bfloat16")
    pos = np.arange(4)[None]
    got = t_attn.apply_rope(tx, torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    close(got, j_attn.apply_rope(jx, jnp.asarray(pos)), rtol=2e-2,
          atol=2e-2)


@pytest.mark.parametrize("seq,dim", [(16, 8), (100, 64), (3, 2)])
def test_sinusoidal_positions_match_reference(seq, dim):
    close(t_attn.sinusoidal_positions(seq, dim),
          j_attn.sinusoidal_positions(seq, dim))


def test_default_mask_value_is_finite():
    assert t_attn.DEFAULT_MASK_VALUE == j_attn.DEFAULT_MASK_VALUE
    assert np.isfinite(t_attn.DEFAULT_MASK_VALUE)


@pytest.mark.parametrize("mask", ["none", "causal", "length", "both"])
@pytest.mark.parametrize("heads,kv", [(4, 2), (4, 4), (6, 1)])
def test_gqa_attention_matches_reference(mask, heads, kv):
    sq, skv = 5, 9
    q, k, v = (normal((2, s, n, 16), i)
               for i, (s, n) in enumerate([(sq, heads), (skv, kv),
                                           (skv, kv)]))
    masks = {"none": (None, None),
             "causal": (j_attn.causal_mask(sq, skv, 3),
                        t_attn.causal_mask(sq, skv, 3)),
             "length": (j_attn.length_mask(skv, 6),
                        t_attn.length_mask(skv, 6))}
    masks["both"] = (masks["causal"][0] & masks["length"][0],
                     masks["causal"][1] & masks["length"][1])
    jm, tm = masks[mask]
    got = t_attn.gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               tm)
    want = j_attn.gqa_attention(*(jnp.asarray(a) for a in (q, k, v)), jm)
    close(got, want)


def test_gqa_maps_query_head_to_kv_head_floor_div():
    """Query head h reads kv head h // G ([B, S, K, G, D]), not h % K."""
    q, k, v = (torch.from_numpy(normal((1, 3, n, 8), i))
               for i, n in enumerate([4, 2, 2]))
    got = t_attn.gqa_attention(q, k, v)

    def dense(idx):
        kk, vv = k[:, :, idx], v[:, :, idx]
        p = torch.softmax(torch.einsum("bqhd,bshd->bhqs", q, kk)
                          * 8 ** -0.5, -1)
        return torch.einsum("bhqs,bshd->bqhd", p, vv)

    torch.testing.assert_close(got, dense(torch.tensor([0, 0, 1, 1])),
                               **TOL)
    assert not torch.allclose(got, dense(torch.tensor([0, 1, 0, 1])),
                              atol=1e-3)


@pytest.mark.parametrize("causal,q_offset,kv_valid,skip", [
    (True, 0, None, False), (True, 0, None, True), (False, 0, None, False),
    (True, 16, None, False), (True, 16, None, True), (False, 0, 40, False),
    (True, 8, 50, True)])
def test_chunked_attention_matches_reference(causal, q_offset, kv_valid,
                                             skip):
    sq, skv = 32, 64
    q, k, v = (normal((2, s, n, 16), 10 + i)
               for i, (s, n) in enumerate([(sq, 4), (skv, 2), (skv, 2)]))
    kw = dict(causal=causal, q_offset=q_offset, q_chunk=8, kv_chunk=16,
              kv_valid=kv_valid, skip_masked_chunks=skip)
    got = t_attn.chunked_gqa_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), **kw)
    want = j_attn.chunked_gqa_attention(
        *(jnp.asarray(a) for a in (q, k, v)), **kw)
    close(got, want)


def test_chunked_attention_refuses_ragged_chunks():
    q = torch.zeros(1, 10, 2, 8)
    with pytest.raises(ValueError, match="multiples"):
        t_attn.chunked_gqa_attention(q, q, q, q_chunk=4, kv_chunk=4)


def attention_pair(**kw):
    ref = j_attn.Attention(32, 4, 2, 8, qkv_bias=True, **kw)
    mod = t_attn.Attention(32, 4, 2, 8, qkv_bias=True, **kw)
    tree = jax_tree(ref, noise=0.1)
    t_layers.load_jax_params(mod, tree)
    return ref, mod, tree


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("seq,threshold", [(12, 1024), (32, 16)])
def test_attention_forward_matches_reference(causal, rope, seq, threshold):
    ref, mod, tree = attention_pair(causal=causal, rope=rope,
                                    chunk_threshold=threshold, q_chunk=8,
                                    kv_chunk=16)
    jx, tx = both(normal((2, seq, 32), 20))
    close(mod(tx), ref(tree, jx))


def test_attention_cross_and_masked_forward_match_reference():
    ref, mod, tree = attention_pair(causal=False)
    jx, tx = both(normal((2, 6, 32), 21))
    je, te = both(normal((2, 10, 32), 22))
    jkv, tkv = ref.cross_kv(tree, je), mod.cross_kv(te)
    for got, want in zip(tkv, jkv):
        close(got, want)
    close(mod(tx, kv=tkv), ref(tree, jx, kv=jkv))
    close(mod(tx, mask=t_attn.length_mask(6, 4)),
          ref(tree, jx, mask=j_attn.length_mask(6, 4)))
    for valid in (None, 7):
        close(mod.cross_decode_step(tx[:, :1], *tkv, kv_valid=valid),
              ref.cross_decode_step(tree, jx[:, :1], *jkv, kv_valid=valid))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_steps_match_reference(dtype):
    ref, mod, tree = attention_pair()
    jcache = j_attn.KVCache.zeros(2, 16, 2, 8, dtype=getattr(jnp, dtype))
    tcache = t_attn.KVCache.zeros(2, 16, 2, 8, dtype=getattr(torch, dtype))
    xs = normal((2, 7, 32), 23)
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for start, stop in [(0, 4), (4, 5), (5, 6), (6, 7)]:
        jx, tx = both(xs[:, start:stop])
        jout, jcache = ref.decode_step(tree, jx, jcache)
        tout, tcache = mod.decode_step(tx, tcache)
        close(tout, jout, **tol)
        assert tcache.length == int(jcache.length) == stop
        close(tcache.k, jcache.k, **tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads,kv", [(4, 2), (4, 4)])
def test_flash_route_matches_reference_pallas(causal, heads, kv):
    """use_flash on the condition of repro/nn/attention.py:274: the port
    calls its flash entry (the plain version on the CPU), the reference
    its Pallas kernel in interpret mode."""
    kw = dict(qkv_bias=True, causal=causal, use_flash=True)
    ref = j_attn.Attention(32, heads, kv, 8, **kw)
    mod = t_attn.Attention(32, heads, kv, 8, **kw)
    tree = jax_tree(ref, noise=0.1)
    t_layers.load_jax_params(mod, tree)
    jx, tx = both(normal((1, 128, 32), 24))
    close(mod(tx), ref(tree, jx), rtol=2e-5, atol=2e-5)


def test_flash_route_is_taken_only_without_mask_or_kv(monkeypatch):
    from repro_torch.kernels.flash_attention import ops
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, mod, _ = attention_pair(use_flash=True)
    x = torch.from_numpy(normal((1, 16, 32), 25))
    mod(x)
    mod(x, mask=t_attn.causal_mask(16, 16))
    mod(x, kv=mod.cross_kv(x))
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [0, 3, 10, 12, 15, 40])
def test_kvcache_update_clamps_like_dynamic_update_slice(length):
    k0, v0 = normal((2, 12, 2, 4), 30), normal((2, 12, 2, 4), 31)
    kn, vn = normal((2, 3, 2, 4), 32), normal((2, 3, 2, 4), 33)
    jc = j_attn.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                        jnp.asarray(length, jnp.int32))
    tc = t_attn.KVCache(torch.from_numpy(k0.copy()),
                        torch.from_numpy(v0.copy()), length)
    jc = jc.update(jnp.asarray(kn), jnp.asarray(vn))
    tc = tc.update(torch.from_numpy(kn), torch.from_numpy(vn))
    close(tc.k, jc.k, rtol=0, atol=0)
    close(tc.v, jc.v, rtol=0, atol=0)
    assert tc.length == int(jc.length) == length + 3


E4M3_BOUNDARY = [0.0, 1e-9, 240.0, 447.0, 448.0, 449.0, 456.0, 463.9,
                 464.0, 464.1, 466.0, 479.0, 480.0, 1e4, np.inf, np.nan]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_float8_cast_matches_reference_at_overflow(dtype, sign):
    x = sign * np.asarray(E4M3_BOUNDARY, np.float32)
    jx, tx = both(x, dtype)
    want = np.asarray(jx.astype(jnp.float8_e4m3fn).astype(jnp.float32))
    got = t_attn.to_kv_dtype(tx, torch.float8_e4m3fn)
    assert got.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(got.float().numpy(), want)
    # torch's own cast saturates where the reference's gives NaN
    assert not tx.to(torch.float8_e4m3fn).float().isnan()[-3:-1].any()
    assert np.isnan(want[-3:]).all()


def test_float8_cast_matches_reference_on_random_values():
    x = normal((200000,), 34, 150.0)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)
                      .astype(jnp.float32))
    got = t_attn.to_kv_dtype(torch.from_numpy(x), torch.float8_e4m3fn)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert np.isnan(want).any()


def test_argmax_ties_take_the_first_index():
    x = np.asarray([1.0, 3.0, 3.0, 2.0, 3.0], np.float32)
    assert int(torch.argmax(torch.from_numpy(x))) == int(jnp.argmax(x)) == 1


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

_MODELS = {}


def lm_pair(arch: str):
    """(reference model, its params, the port's model loaded from them,
    cfg) for an arch's smoke config, built once per arch."""
    if arch not in _MODELS:
        ref = j_registry.build_model(j_registry.get_config(arch))
        tree = jax_tree(ref)
        mod = t_layers.load_jax_lm_params(
            registry.build_model(registry.get_config(arch), "cpu"), tree)
        _MODELS[arch] = (ref, tree, mod, registry.get_config(arch))
    return _MODELS[arch]


def lm_inputs(cfg, batch=2, seq=17, seed=40):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    extras = {}
    if cfg.num_patches:
        extras["patch_embeds"] = normal((batch, cfg.num_patches,
                                         cfg.d_model), seed + 1)
    return toks, extras


def j_kw(extras):
    return {k: jnp.asarray(v) for k, v in extras.items()}


def t_kw(extras):
    return {k: torch.from_numpy(v) for k, v in extras.items()}


@pytest.mark.parametrize("arch", [a + "-smoke" for a in DENSE_ARCHS])
def test_decoder_forward_matches_reference(arch):
    ref, tree, mod, cfg = lm_pair(arch)
    toks, extras = lm_inputs(cfg)
    want = ref(tree, jnp.asarray(toks), **j_kw(extras))
    with torch.no_grad():
        got = mod(torch.from_numpy(toks), **t_kw(extras))
    assert got.logits.dtype == torch.float32
    assert got.logits.shape == (2, 17, cfg.vocab_size)
    close(got.logits, want.logits)
    assert set(got.aux) == set(want.aux)
    for name in got.aux:
        close(got.aux[name], want.aux[name])


@pytest.mark.parametrize("arch", [a + "-smoke" for a in DENSE_ARCHS])
def test_decoder_prefill_and_decode_match_reference(arch):
    ref, tree, mod, cfg = lm_pair(arch)
    toks, extras = lm_inputs(cfg, seq=13, seed=41)
    jout, jcache = ref.prefill(tree, jnp.asarray(toks[:, :-1]), max_len=24,
                               **j_kw(extras))
    with torch.no_grad():
        tout, tcache = mod.prefill(torch.from_numpy(toks[:, :-1]),
                                   max_len=24, **t_kw(extras))
    close(tout.logits, jout.logits)
    assert tcache.k.shape == jcache.k.shape
    assert tcache.length == int(jcache.length)
    close(tcache.k, jcache.k)
    close(tcache.v, jcache.v)
    for step in range(2):
        tok = toks[:, -1:] if step == 0 else np.argmax(
            to_np(tout.logits[:, -1]), -1)[:, None].astype(np.int32)
        jout, jcache = ref.decode_step(tree, jnp.asarray(tok), jcache)
        with torch.no_grad():
            tout, tcache = mod.decode_step(torch.from_numpy(tok), tcache)
        close(tout.logits, jout.logits)
        assert tcache.length == int(jcache.length)
    close(tcache.k, jcache.k)


def test_decoder_forward_through_chunked_path_at_1024_tokens():
    ref, tree, mod, cfg = lm_pair("qwen1.5-4b-smoke")
    toks, _ = lm_inputs(cfg, batch=1, seq=1024, seed=42)
    want = ref(tree, jnp.asarray(toks))
    with torch.no_grad():
        got = mod(torch.from_numpy(toks))
    close(got.logits, want.logits)


def test_decoder_in_bf16_gives_fp32_logits_and_float8_cache():
    cfg = dataclasses.replace(registry.get_config("qwen1.5-4b-smoke"),
                              compute_dtype="bfloat16",
                              kv_cache_dtype="float8_e4m3fn")
    jcfg = dataclasses.replace(j_registry.get_config("qwen1.5-4b-smoke"),
                               compute_dtype="bfloat16",
                               kv_cache_dtype="float8_e4m3fn")
    ref = j_registry.build_model(jcfg)
    tree = jax_tree(ref)
    mod = t_layers.load_jax_lm_params(registry.build_model(cfg, "cpu"),
                                      tree)
    toks, _ = lm_inputs(cfg, seq=9, seed=43)
    with torch.no_grad():
        out, cache = mod.prefill(torch.from_numpy(toks), max_len=16)
        full = mod(torch.from_numpy(toks))
    jout, jcache = ref.prefill(tree, jnp.asarray(toks), max_len=16)
    assert out.logits.dtype == full.logits.dtype == torch.float32
    assert cache.k.dtype == torch.float8_e4m3fn
    assert mod.kv_dtype() == torch.float8_e4m3fn
    # bf16 activations round at other places in the two frameworks
    close(out.logits, jout.logits, rtol=5e-2, atol=5e-2)
    assert mod.init_cache(3, 16).k.shape == (2, 3, 16, 4, 32)


# ---------------------------------------------------------------------------
# registry and the weight carry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(j_registry.ARCH_IDS)
                         + [a + "-smoke" for a in j_registry.ARCH_IDS])
def test_configs_equal_the_reference(arch):
    got, want = registry.get_config(arch), j_registry.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.param_count_estimate() == want.param_count_estimate()
    assert (got.active_param_count_estimate()
            == want.active_param_count_estimate())
    assert [got.supports_shape(s) for s in SHAPES] == \
        [want.supports_shape(s) for s in J_SHAPES]


def test_registry_ids_shapes_and_cells_equal_the_reference():
    assert registry.ARCH_IDS == j_registry.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert registry.runnable_cells() == j_registry.runnable_cells()
    with pytest.raises(KeyError):
        registry.get_config("no-such-arch")


@pytest.mark.parametrize("arch", [a + "-smoke"
                                  for a in j_registry.ARCH_IDS])
def test_parameter_counts_equal_the_reference(arch):
    _, tree, mod, _ = lm_pair(arch)
    assert sum(p.numel() for p in mod.parameters()) == param_count(tree)


@pytest.mark.parametrize("arch", j_registry.ARCH_IDS)
def test_full_size_parameter_counts_equal_the_reference(arch):
    """Every arch at full size, counted without allocating: the port's
    model built on the meta device against the reference's abstract
    init (`jax.eval_shape`)."""
    ref = j_registry.build_model(j_registry.get_config(arch))
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    want = sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(shapes))
    mod = registry.build_model(registry.get_config(arch), "meta")
    assert sum(p.numel() for p in mod.parameters()) == want


def test_build_model_refuses_an_unknown_family():
    cfg = dataclasses.replace(registry.get_config("qwen1.5-4b-smoke"),
                              family="diffusion")
    with pytest.raises(ValueError, match="unknown family"):
        registry.build_model(cfg, "cpu")


def test_build_model_needs_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_config("qwen1.5-4b-smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.build_model(cfg)
    assert registry.build_model(cfg, "cpu").embed.table.device.type == "cpu"


def test_init_params_draws_on_the_parameters_device():
    cfg = registry.get_config("qwen1.5-4b-smoke")
    a = t_layers.init_params(registry.build_model(cfg, "cpu"), 0)
    b = t_layers.init_params(registry.build_model(cfg, "cpu"), 0)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert a.blocks[0].attn.wq.w.abs().max() > 0
    assert torch.all(a.blocks[0].norm1.scale == 1)


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape",
                                   "depth"])
def test_weight_carry_refuses_bad_trees(fault):
    _, tree, _, cfg = lm_pair("qwen1.5-4b-smoke")
    tree = jax.tree_util.tree_map(np.copy, tree)
    if fault == "missing":
        del tree["blocks"]["ffn"]["wg"]
    elif fault == "unexpected":
        tree["blocks"]["attn"]["extra"] = {"w": np.zeros((2, 3))}
    elif fault == "shape":
        tree["final_norm"]["scale"] = np.ones(cfg.d_model + 1, np.float32)
    else:
        tree["blocks"]["norm1"]["scale"] = tree["blocks"]["norm1"][
            "scale"][:1]
    with pytest.raises(ValueError):
        t_layers.load_jax_lm_params(registry.build_model(cfg, "cpu"), tree)
