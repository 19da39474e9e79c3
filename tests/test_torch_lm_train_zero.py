"""`Adafactor` with ``group=`` and ``shard_dims=`` (ZeRO-1 slices) on 2
gloo ranks against the replicated update, on the CPU: three updates of a
tree with a row-sliced 2-D leaf, a replicated 1-D leaf, a layer stack
(``blocks.{0,1}.k``, stacked by the update and sliced on its columns)
and a 3-D leaf sliced on its middle dim; every rank's new parameter
slices within rtol 1e-6 of the replicated result's.  The slices' means
are all-reduced over the group where the reference takes `pmean`.

This file imports no JAX: the spawned ranks import it to find their
function, so it stays light (the rest of the optimizer's tests are in
`test_torch_lm_train.py`).
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed.launch import run_ranks
from repro_torch.nn import layers as t_layers
from repro_torch.train import optimizer as t_opt


def normal(shape, seed, scale=1.0):
    return np.asarray(scale * np.random.default_rng(seed)
                      .standard_normal(shape), np.float32)


ZERO_SHAPES = {"w": (8, 6), "b": (6,), "blocks.0.k": (4, 6),
               "blocks.1.k": (4, 6), "e": (4, 8, 6)}
ZERO_DIMS = {"w": 0, "b": -1, "blocks.0.k": 1, "blocks.1.k": 1, "e": 1}


def _cut(x, dim, rank):
    if dim < 0:
        return x
    width = x.shape[dim] // 2
    return x.narrow(dim, rank * width, width).clone()


def adafactor_zero_rank():
    """A rank of the 2-rank Adafactor check: three updates of this
    rank's ZeRO slices under the group, and the replicated update of the
    full tree; returns both (this rank's slices of the full result)."""
    import torch.distributed as dist

    from repro_torch.distributed.collectives import Axis
    rank = dist.get_rank()
    axis = Axis("data", 2, rank, (0, 1), None)
    opt = t_opt.Adafactor(learning_rate=1e-2, weight_decay=0.01)
    full = {k: torch.from_numpy(normal(s, i)) for i, (k, s)
            in enumerate(ZERO_SHAPES.items())}
    mine = {k: _cut(v, ZERO_DIMS[k], rank) for k, v in full.items()}
    groups = t_layers.stack_groups(full)
    s_full, s_mine = opt.init(full, groups), opt.init(full, groups)
    # the sliced state: each moment cut where its leaf is cut
    for key, names in groups.items():
        dim = ZERO_DIMS[names if isinstance(names, str) else names[0]]
        if dim < 0:
            continue
        if not isinstance(names, str):
            dim += 1
        nd = s_full.vr[key].ndim + 1
        if dim < nd - 1:  # vr keeps every dim but the last
            s_mine.vr[key] = _cut(s_mine.vr[key], dim, rank)
        if dim != nd - 2:  # vc drops the second-to-last
            s_mine.vc[key] = _cut(s_mine.vc[key],
                                  dim if dim < nd - 2 else dim - 1, rank)
    for step in range(3):
        grads = {k: torch.from_numpy(normal(s, 50 + 10 * step + i, 0.5))
                 for i, (k, s) in enumerate(ZERO_SHAPES.items())}
        full, s_full, _ = opt.update(grads, s_full, full, groups=groups)
        g_mine = {k: _cut(v, ZERO_DIMS[k], rank) for k, v in grads.items()}
        mine, s_mine, _ = opt.update(g_mine, s_mine, mine, group=axis,
                                     shard_dims=ZERO_DIMS, groups=groups)
    return ({k: v.numpy() for k, v in mine.items()},
            {k: _cut(v, ZERO_DIMS[k], rank).numpy()
             for k, v in full.items()})


@pytest.mark.timeout(120)
def test_adafactor_zero_slices_match_replicated_on_two_ranks():
    for mine, want in run_ranks(adafactor_zero_rank, 2, threads=1,
                                timeout_s=120):
        for k in ZERO_SHAPES:
            np.testing.assert_allclose(mine[k], want[k], rtol=1e-6,
                                       atol=1e-8, err_msg=k)
