"""The port's LM train step against the JAX package for the other
families, on the CPU: granite-moe-3b-a800m and arctic-480b (MoE, the
load-balance and router z-loss terms in the total), rwkv6-3b, zamba2-1.2b
(the shared block applied after each Mamba2 group, its gradient the sum
over its uses) and whisper-medium (the encoder fed stubbed frame
embeddings), each at its ``-smoke`` config.  The checks and tolerances
are `test_torch_lm_train_arch.py`'s (its module docstring): three steps'
losses, step-1 gradients by ``|d| <= 1e-6 + 1e-4 * |g|`` (misses judged
by the reference's float64 gradient, counted and capped a leaf),
``n_microbatches=2`` on granite-moe-3b-a800m and `make_eval_step`'s
metrics.
"""
import pytest

from test_torch_lm_train_arch import check_eval, check_run

FAMILIES = ["granite-moe-3b-a800m", "arctic-480b", "rwkv6-3b",
            "zamba2-1.2b", "whisper-medium"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_match_reference(arch):
    check_run(arch)


def test_microbatched_moe_step_matches_reference():
    check_run("granite-moe-3b-a800m", steps=2, n_micro=2, batch=4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_eval_step_matches_reference(arch):
    check_eval(arch)
