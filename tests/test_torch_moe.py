"""The port's `MoELayer` (`repro_torch.nn.moe`) against the JAX package's,
on the CPU.

Inputs come from a numpy seed; parameters are the reference's
``split_params(MoELayer.init(PRNGKey(0)))[0]`` carried across with
`load_jax_params`, every leaf perturbed by seeded noise.  Each case holds
the output and all three auxiliary values (load-balance loss, router
z-loss, drop fraction) to the reference:

* T = 12 tokens: 4 groups of 3 (the group count halved from 16 until it
  divides T), and T = 13: one group;
* capacity_factor 0.25: assignments dropped past each expert's capacity
  in GShard's order (the first of a group keep their place);
* a dense residual MLP (arctic-480b's) and a plain, non-gated expert;
* ties: a router of zero weights makes every probability equal, so top-k
  must pick the experts in index order, as `jax.lax.top_k` does
  (`torch.topk` leaves their order open);
* bf16 compute.

Also `capacity` and `top_k` themselves, and the expert draw of
`init_params` (each expert lecun-normal on its own).

Tolerances: fp32 rtol 1e-5 / atol 1e-5; bf16 2e-2 (a bf16 ulp at the
outputs' scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as j_moe

from repro_torch.nn import layers as t_layers
from repro_torch.nn import moe as t_moe
from test_torch_lm import TOL, both, close, jax_tree, normal

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def moe_pair(noise=0.05, **kw):
    """(reference layer, its perturbed params, the port's layer loaded
    from them)."""
    args = (32, 48, kw.pop("n_experts", 4), kw.pop("top_k", 2))
    ref = j_moe.MoELayer(*args, **kw)
    mod = t_moe.MoELayer(*args, **kw)
    tree = jax_tree(ref, noise=noise)
    t_layers.load_jax_params(mod, tree)
    return ref, mod, tree


def check(ref, mod, tree, x, tol=TOL):
    jx, tx = x
    want, jaux = ref(tree, jx)
    with torch.no_grad():
        got, taux = mod(tx)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    close(got, want, **tol)
    for name in t_moe.MoEAux._fields:
        close(getattr(taux, name), getattr(jaux, name), **TOL)
    return taux


@pytest.mark.parametrize("shape", [(2, 6), (1, 12), (13,), (4, 16)])
def test_moe_matches_reference_across_group_counts(shape):
    ref, mod, tree = moe_pair()
    aux = check(ref, mod, tree, both(normal(shape + (32,), 1)))
    assert float(aux.drop_fraction) == 0.0  # capacity 8 > any group here


@pytest.mark.parametrize("capacity_factor", [0.25, 0.5])
def test_moe_drops_in_gshard_order(capacity_factor):
    ref, mod, tree = moe_pair(capacity_factor=capacity_factor,
                              capacity_multiple=2, n_experts=4, top_k=2)
    aux = check(ref, mod, tree, both(normal((2, 24, 32), 2)))
    assert 0.0 < float(aux.drop_fraction) < 1.0


@pytest.mark.parametrize("shape", [(4, 1), (1, 13), (2, 64)])
def test_moe_at_granites_routing_matches_reference(shape):
    """granite-moe-3b-a800m's routing (40 experts, top 8, capacity factor
    1.0) at a narrow width: the 4-slot decode (4 groups of 1), a 13-token
    prompt (one group) and 128 tokens (16 groups of 8)."""
    ref, mod, tree = moe_pair(n_experts=40, top_k=8, capacity_factor=1.0)
    check(ref, mod, tree, both(normal(shape + (32,), 7)))


def test_moe_with_dense_residual_matches_reference():
    ref, mod, tree = moe_pair(dense_residual_hidden=40)
    assert mod.dense is not None and "dense" in tree
    check(ref, mod, tree, both(normal((2, 6, 32), 3)))


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_moe_plain_experts_match_reference(activation):
    ref, mod, tree = moe_pair(gated=False, activation=activation,
                              normalize_gates=False)
    assert mod.wg is None and "wg" not in tree
    check(ref, mod, tree, both(normal((3, 4, 32), 4)))


def test_moe_ties_pick_experts_in_index_order():
    """Zero router weights: every probability is 1/E, so every token's
    top-k are experts 0..k-1 in both packages, and their outputs agree."""
    ref, mod, tree = moe_pair(n_experts=6, top_k=3)
    tree["router"]["w"] = np.zeros_like(tree["router"]["w"])
    t_layers.load_jax_params(mod, tree)
    x = both(normal((2, 5, 32), 5))
    with torch.no_grad():
        probs = torch.softmax(mod.router(x[1]).float(), -1)
    _, ids = t_moe.top_k(probs, 3)
    _, jids = jax.lax.top_k(jax.nn.softmax(
        ref.router(tree["router"], x[0]).astype(jnp.float32), -1), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (ids.numpy() == [0, 1, 2]).all()
    check(ref, mod, tree, x)


@pytest.mark.parametrize("seed", range(4))
def test_top_k_order_equals_lax_top_k_on_ties(seed):
    rng = np.random.default_rng(seed)
    probs = rng.integers(0, 4, (64, 10)).astype(np.float32)  # many ties
    vals, ids = t_moe.top_k(torch.from_numpy(probs), 4)
    jvals, jids = jax.lax.top_k(jnp.asarray(probs), 4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_moe_in_bf16_matches_reference():
    ref, mod, tree = moe_pair()
    check(ref, mod, tree, both(normal((2, 8, 32), 6), "bfloat16"),
          BF16_TOL)


@pytest.mark.parametrize("n_tokens", [1, 3, 12, 40, 41, 128, 1000])
@pytest.mark.parametrize("factor", [0.25, 1.0, 1.25, 4.0])
def test_capacity_equals_reference(n_tokens, factor):
    args = (8, 8, 40, 8)
    ref = j_moe.MoELayer(*args, capacity_factor=factor)
    assert t_moe.MoELayer(*args, capacity_factor=factor).capacity(
        n_tokens) == ref.capacity(n_tokens)
    assert t_moe._round_up(n_tokens, 8) == j_moe._round_up(n_tokens, 8)


def test_init_params_draws_each_expert_lecun_normal():
    mod = t_layers.init_params(t_moe.MoELayer(64, 96, 5, 2), 0)
    again = t_layers.init_params(t_moe.MoELayer(64, 96, 5, 2), 0)
    for name, fan_in in (("wi", 64), ("wg", 64), ("wo", 96)):
        w = getattr(mod, name).detach()
        assert torch.equal(w, getattr(again, name))  # a function of the seed
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        assert w.abs().max() <= 2 * std  # truncated at two std
        assert abs(w.std().item() - (1.0 / fan_in) ** 0.5) < 0.1 * std
        assert not torch.equal(w[0], w[1])  # drawn an expert at a time
    assert mod.router.w.abs().max() > 0
    ref = t_layers._flatten_tree(jax_tree(j_moe.MoELayer(64, 96, 5, 2)))
    assert {k: tuple(p.shape) for k, p in mod.named_parameters()} == \
        {k: v.shape for k, v in ref.items()}
