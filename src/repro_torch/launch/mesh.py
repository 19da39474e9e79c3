"""Production and host meshes over `torch.distributed` ranks
(counterpart of `repro.launch.mesh`).

Defined as functions, so importing this module touches no process
group.  A mesh position is a rank (`repro_torch.distributed.partition`),
so the production meshes need a world of 256 or 512 ranks: a fake one
in one process (`repro_torch.launch.dryrun`, which traces rank 0), or
real ranks (`repro_torch.distributed.launch.run_ranks`).
"""
from __future__ import annotations

import numpy as np

from repro_torch.distributed import partition
from repro_torch.distributed.partition import Mesh

PRODUCTION_MODEL = 16   # the "model" axis of the production meshes
PRODUCTION_DATA = 16
PRODUCTION_PODS = 2


def production_shape(multi_pod: bool = False) -> tuple:
    """(pod, data, model) or (data, model) of the production mesh."""
    if multi_pod:
        return (PRODUCTION_PODS, PRODUCTION_DATA, PRODUCTION_MODEL)
    return (PRODUCTION_DATA, PRODUCTION_MODEL)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 ranks ("data", "model"); two pods add a leading
    "pod" axis (512 ranks).  Raises RuntimeError when the initialized
    world has fewer ranks."""
    shape = production_shape(multi_pod)
    n = int(np.prod(shape))
    have = partition.world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} ranks, have {have} — trace rank 0 of a fake world "
            f"(python -m repro_torch.launch.dryrun), or start {n} ranks "
            "(repro_torch.distributed.launch.run_ranks)")
    return partition.make_mesh(n, model_parallel=PRODUCTION_MODEL,
                               pods=PRODUCTION_PODS if multi_pod else 1)


def make_host_mesh(n_devices: int | None = None,
                   axes: tuple = ("data", "model"),
                   shape: tuple | None = None) -> Mesh:
    """A small mesh over the ranks there are (tests on 1-8 ranks):
    ``shape`` per name of ``axes`` ("pod", "data", "model"), (n, 1) by
    default."""
    n = n_devices or partition.world_size()
    if shape is None:
        shape = (n, 1)
    sizes = dict(zip(axes, shape))
    unknown = set(sizes) - {partition.POD_AXIS, partition.DATA_AXIS,
                            partition.MODEL_AXIS}
    if unknown or int(np.prod(shape)) != n:
        raise ValueError(f"a host mesh of {n} ranks over {dict(sizes)}")
    return partition.make_mesh(n, model_parallel=sizes.get("model", 1),
                               pods=sizes.get("pod", 1))
