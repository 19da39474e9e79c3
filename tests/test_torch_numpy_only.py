"""The port's sampler hosts are numpy-only, checked at run time, and the
module names that keep the reference's lint rules live.

* A subprocess whose `sys.meta_path` refuses any `torch` import (as
  tests/test_worker_numpy_only.py refuses jax) imports the dial-in worker,
  the sampling service and its multi-host endpoint and client, builds a padded batch through
  `SamplerWorker.build_step` and through an `MmapGraphStore`, and ends
  with torch absent from `sys.modules`.
* repro-lint finds the reference's wire module and both sampler workers
  by dotted suffix, and `find_suffix` returns None when two modules
  match, which switches WIRE001 and PUR005 off without a word.  Over all
  of `src/`, port included, each suffix must resolve to the reference's
  module.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools.repro_lint.engine import Project, discover  # noqa: E402

_SCRIPT = textwrap.dedent("""
    import sys
    import tempfile

    class _BlockTorch:
        # a finder FIRST in line: any attempt to import torch fails loudly
        def find_spec(self, name, path=None, target=None):
            if name == "torch" or name.startswith("torch."):
                raise ImportError(f"torch import blocked by test: {name}")
            return None

    sys.meta_path.insert(0, _BlockTorch())

    import numpy as np
    import repro_torch.sampling_service.remote
    import repro_torch.sampling_service.service
    import repro_torch.serve
    import repro_torch.serve.loadgen
    import repro_torch.storage.dial_worker
    from repro_torch.core.schema import mag_schema
    from repro_torch.data.batching import find_size_constraints
    from repro_torch.data.grouping import BatchPlan
    from repro_torch.data.sampling import (InMemorySampler,
                                           SamplingSpecBuilder)
    from repro_torch.data.synthetic import synthetic_mag
    from repro_torch.orchestration.providers import StoreProvider
    from repro_torch.sampling_service import frames
    from repro_torch.sampling_service.sampler_worker import SamplerWorker
    from repro_torch.storage import MmapGraphStore, write_graph

    store, _ = synthetic_mag(n_papers=120, n_authors=60, n_institutions=6,
                             n_fields=12, n_classes=4, feat_dim=16)
    b = SamplingSpecBuilder(mag_schema())
    seed_op = b.seed("paper")
    seed_op.sample(4, "cites")
    spec = seed_op.build()
    roots = list(range(32))
    sizes = find_size_constraints(
        InMemorySampler(store, spec, seed=0).sample(roots[:8]), 4)
    plan = BatchPlan(8, seed=0, num_replicas=2)
    worker = SamplerWorker(0, sock=None, store=store, spec=spec,
                           seeds=roots, plan=plan, sizes=sizes)
    batch = worker.build_step(epoch=0, step=1)
    leaf = batch.node_sets["paper"].features["feat"]
    assert isinstance(leaf, np.ndarray), type(leaf)
    assert leaf.ndim == 3  # [R, padded_nodes, feat] super-batch layout
    assert len(frames.encode_frame(frames.BATCH, {}, batch)) > leaf.nbytes
    with tempfile.TemporaryDirectory() as tmp:
        mmap = MmapGraphStore(write_graph(store, tmp + "/g"),
                              gather_chunk_rows=4)
        stream = StoreProvider(mmap, spec, roots, batch_size=8,
                               sizes=sizes, num_replicas=2).epoch(0)
        next(stream)
        again = next(stream)
    np.testing.assert_array_equal(
        again.node_sets["paper"].features["feat"], leaf)
    assert "torch" not in sys.modules, "torch leaked into the sampler"
    print("OK", leaf.shape)
""")


def test_sampler_hosts_build_batches_with_torch_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_lint_suffixes_resolve_to_the_reference_modules():
    project = Project(discover([str(REPO / "src")]))
    for suffix, module in (
            ("sampling_service.wire", "repro.sampling_service.wire"),
            ("sampling_service.worker", "repro.sampling_service.worker"),
            ("storage.worker", "repro.storage.worker")):
        found = project.find_suffix(suffix)
        assert found is not None, f"{suffix}: two modules match"
        assert found.module_name == module
    # the port's renamed copies are there, under names of their own
    names = {m.module_name for m in project.modules}
    assert {"repro_torch.sampling_service.frames",
            "repro_torch.sampling_service.sampler_worker",
            "repro_torch.storage.dial_worker"} <= names
