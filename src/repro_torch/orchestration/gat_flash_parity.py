"""Flash-attention GAT parity driver (the port's twin of
`examples/gat_flash_parity.py`).

Builds the example's padded four-component node batch (17, 9, 23 and 30
nodes, 16-wide states, padded to 96 nodes and 192 edges), runs
`GraphSelfAttention(num_heads=4, per_head_channels=8, in_dim=16)` over it
once through the kernel path and once through `registry.plain_versions()`,
and returns the masked mean-square loss and the parameter gradients of
both, with the flash kernel's launches in the forward and the backward.
On the card the kernel path launches the CUDA flash kernel; on the CPU
both paths run the plain version.  `run` also takes another graph, node
set and width, which is how `chip_smoke.py` runs it at full width:

    from repro_torch.orchestration import gat_flash_parity
    gat_flash_parity.run(device="cuda").check()
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph_tensor import (Adjacency, Context, EdgeSet,
                                           GraphTensor, HIDDEN_STATE,
                                           NodeSet, resolve_device,
                                           to_device)
from repro_torch.data.batching import (SizeConstraints, merge_graphs,
                                       pad_to_sizes)
from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.nn.graph_attention import GraphSelfAttention
from repro_torch.nn.layers import init_params, load_jax_params

DIM = 16
NODE_COUNTS = (17, 9, 23, 30)
SIZES = SizeConstraints(total_num_components=5,
                        total_num_nodes={"nodes": 96},
                        total_num_edges={"links": 192})


def component(seed: int, n_nodes: int) -> GraphTensor:
    """One graph of `n_nodes` nodes with standard-normal states and
    2 * n_nodes random links, drawn as the example draws them."""
    rng = np.random.default_rng(seed)
    e = 2 * n_nodes
    states = rng.standard_normal((n_nodes, DIM)).astype(np.float32)
    src = rng.integers(0, n_nodes, e)
    tgt = rng.integers(0, n_nodes, e)
    return GraphTensor(
        Context(np.asarray([1], np.int32), {}),
        {"nodes": NodeSet(np.asarray([n_nodes], np.int32),
                          {HIDDEN_STATE: states}, n_nodes)},
        {"links": EdgeSet(np.asarray([e], np.int32),
                          Adjacency(src, tgt, "nodes", "nodes"), {}, e)})


def example_graph() -> GraphTensor:
    """The example's batch on the host: merged, then padded."""
    return pad_to_sizes(merge_graphs([component(i, n) for i, n in
                                      enumerate(NODE_COUNTS)]), SIZES)


@dataclasses.dataclass
class ParityResult:
    """Loss and gradients ({parameter name: tensor on the CPU}) through
    the kernel path and the plain path, and the flash kernel's launches
    in the kernel path's forward and backward."""
    loss: float
    grads: dict
    plain_loss: float
    plain_grads: dict
    forward_launches: int
    backward_launches: int

    def check(self) -> None:
        """Raise AssertionError unless the paths agree within the
        example's fp32 tolerances (loss rtol 1e-5 / atol 1e-6, gradients
        rtol 1e-4 / atol 1e-5)."""
        np.testing.assert_allclose(self.loss, self.plain_loss, rtol=1e-5,
                                   atol=1e-6)
        assert sorted(self.grads) == sorted(self.plain_grads)
        for name, g in self.grads.items():
            np.testing.assert_allclose(g.numpy(),
                                       self.plain_grads[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def run(device=None, *, graph: GraphTensor | None = None,
        node_set: str = "nodes", in_dim: int = DIM, num_heads: int = 4,
        per_head_channels: int = 8, params=None,
        seed: int = 0) -> ParityResult:
    """Loss and gradients of `GraphSelfAttention` over `node_set` of
    `graph` (default: the example's batch), kernel path vs plain path.

    `graph` may be a host (numpy) GraphTensor or one already on
    `device`.  Parameters: `params`, a tree in the reference's layout
    (e.g. the numpy leaves of the JAX module's ``split_params(init)[0]``),
    or else ``init_params(module, seed)``.  `device` defaults to CUDA and
    raises without a card."""
    device = resolve_device(device)
    if graph is None:
        graph = example_graph()
    if isinstance(graph.context.sizes, np.ndarray):
        graph = to_device(graph, device)
    module = GraphSelfAttention(num_heads, per_head_channels, in_dim)
    if params is not None:
        load_jax_params(module, params)
    else:
        init_params(module, seed)
    module.to(device)
    names = [name for name, _ in module.named_parameters()]
    mask = graph.node_sets[node_set].mask()[:, None]

    def loss_and_grads():
        out = module(graph, node_set)
        loss = torch.where(mask, out, torch.zeros_like(out)).square().mean()
        before = flash_kernel.flash_attention.launches
        grads = torch.autograd.grad(loss, list(module.parameters()))
        backward = flash_kernel.flash_attention.launches - before
        return (loss.item(), {n: g.detach().cpu()
                              for n, g in zip(names, grads)}, backward)

    before = flash_kernel.flash_attention.launches
    loss, grads, backward = loss_and_grads()
    forward = flash_kernel.flash_attention.launches - before - backward
    with registry.plain_versions():
        plain_loss, plain_grads, _ = loss_and_grads()
    return ParityResult(loss, grads, plain_loss, plain_grads, forward,
                        backward)
