"""Data-parallel sharding for GraphTensor super-batches (paper §7;
counterpart of `repro.distributed.graph_sharding`).

The reference keeps this module as the thin 1-D ("data",) surface over
`partition`, and so does the port: every function below delegates to the
`MeshPlan` of its mesh (`repro_torch.distributed.partition`), which owns
placement, the model-axis gather boundary and ZeRO-1.  The unit of data
parallelism is the padded *component group*: `GraphBatcher(num_replicas=R)`
emits stacked GraphTensors whose every leaf has a leading ``[R, ...]``
group axis, each group merged and padded to one SizeConstraints, with
group-local adjacency, so only the gradient mean crosses ranks.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.distributed import partition

GROUP_AXIS = partition.GROUP_AXIS  # logical name of the leading group axis

def make_data_mesh(num_devices: Optional[int] = None) -> partition.Mesh:
    """1-D ("data",) mesh over the ranks of the world (see
    ``partition.make_mesh``; every rank must call it)."""
    return partition.make_mesh(num_devices)


def put_super_batch(graph, labels, mesh: partition.Mesh, *, device=None):
    """This rank's block of a host super-batch and its per-group labels
    on its device (see ``partition.MeshPlan.put_super_batch``)."""
    plan = partition.plan_for(mesh, device=device)
    return plan.put_super_batch(graph, labels)


def replicate(tree: dict, mesh: partition.Mesh) -> dict:
    """Make every rank hold rank 0's values of a {name: tensor} tree."""
    return partition.plan_for(mesh, device="cpu").replicate(tree)


def data_spec(mesh: partition.Mesh) -> tuple:
    """Spec sharding a leading batch/group dim over the data axes."""
    return partition.plan_for(mesh, device="cpu").data_spec()


def make_dp_train_step(mesh: partition.Mesh, loss_fn: Callable, optimizer,
                       *, num_groups: int, zero1: bool = False,
                       device=None) -> Callable:
    """Data-parallel training step (``partition.make_train_step``).
    ZeRO-1 is off on this surface, as in the reference: pass
    ``zero1=True`` (and place the state with
    ``MeshPlan.place_opt_state``) to cut the optimizer state over
    "data"."""
    return partition.make_train_step(
        partition.plan_for(mesh, device=device), loss_fn, optimizer,
        num_groups=num_groups, zero1=zero1)


def make_dp_eval_step(mesh: partition.Mesh, metric_fn: Callable, *,
                      device=None) -> Callable:
    """Data-parallel eval step (``partition.make_eval_step``)."""
    return partition.make_eval_step(
        partition.plan_for(mesh, device=device), metric_fn)
