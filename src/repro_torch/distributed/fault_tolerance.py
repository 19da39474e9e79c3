"""Fault tolerance: atomic async checkpointing with restore (counterpart
of `repro.distributed.fault_tolerance`).

The reference's on-disk layout, kept as it is:

  * each checkpoint is a directory ``step_%010d`` holding ``arrays.npz``
    (``a0``, ``a1``, ... in state order) and ``manifest.json`` (the step,
    each array's index, shape, dtype and sha1, and the caller's
    ``extra``), written to ``<dir>.tmp`` and renamed (atomic);
  * a ``latest`` pointer file names the newest checkpoint, and a
    ``best`` pointer the one `CheckpointManager.mark_best` pinned, which
    retention GC spares;
  * the data pipeline offset (epoch, step in epoch) rides in ``extra``,
    so a restart replays each batch exactly once;
  * a background thread writes (training goes on with the next step),
    and a SIGTERM hook snapshots at once.

State is a tree of dicts, tuples and NamedTuples (`AdamWState`) whose
leaves are tensors or arrays: the Trainer saves ``({name: parameter},
AdamWState)``.  Leaves are named by their path, ``[0]["gnn.x.w"]`` style,
as the reference names them with ``jax.tree_util.keystr``.  A bf16
tensor, which numpy cannot hold, is stored as its int16 bits with dtype
"bfloat16" in the manifest.  Restore returns the tree of `state_like`
with each leaf a tensor on that leaf's device.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

Tree = Any


def _leaves_with_names(tree: Tree, prefix: str = "") -> list:
    """[(name, leaf)] in a fixed order: dict keys sorted, tuple items in
    order."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _leaves_with_names(tree[key], f"{prefix}[{key!r}]")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, sub in enumerate(tree):
            out += _leaves_with_names(sub, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _unflatten(like: Tree, leaves) -> Tree:
    """`like`'s structure, its dicts in their own key order, with its
    leaves taken from the iterator (in `_leaves_with_names`' order)."""
    if isinstance(like, dict):
        subs = {key: _unflatten(like[key], leaves) for key in sorted(like)}
        return {key: subs[key] for key in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):  # NamedTuple
        return type(like)(*(_unflatten(sub, leaves) for sub in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    return next(leaves)


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """(a host copy that owns its memory, the dtype name to record)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def host_state(state: Tree) -> dict:
    """{name: (array, dtype name)}: a host copy of every leaf of `state`,
    taken now (the caller may then update the tensors in place)."""
    return {name: _host_array(leaf)
            for name, leaf in _leaves_with_names(state)}


def save_checkpoint(directory: str, step: int, state: Tree, *,
                    extra: dict | None = None) -> str:
    """Synchronous atomic save of `state`; returns the checkpoint path."""
    return _write(directory, step, host_state(state), extra)


def _write(directory: str, step: int, flat: dict,
           extra: dict | None) -> str:
    """Write `host_state`'s copy `flat` as checkpoint `step`, atomically,
    and point `latest` at it."""
    os.makedirs(directory, exist_ok=True)
    ckpt_dir = os.path.join(directory, f"step_{step:010d}")
    tmp_dir = ckpt_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    manifest = {"step": step, "arrays": {}, "extra": extra or {}}
    with open(os.path.join(tmp_dir, "arrays.npz"), "wb") as f:
        np.savez(f, **{f"a{i}": v for i, (v, _) in
                       enumerate(flat.values())})
    for i, (name, (v, dtype)) in enumerate(flat.items()):
        manifest["arrays"][name] = {
            "index": i, "shape": list(v.shape), "dtype": dtype,
            "sha1": hashlib.sha1(np.ascontiguousarray(v).tobytes())
                    .hexdigest(),
        }
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    # idempotent publish: a step already checkpointed (a restarted run
    # re-saving the step it restored from) keeps its published copy
    if os.path.isdir(ckpt_dir):
        shutil.rmtree(tmp_dir)
    else:
        try:
            os.replace(tmp_dir, ckpt_dir)
        except OSError:
            if not os.path.isdir(ckpt_dir):  # a real failure, not a race
                raise
            shutil.rmtree(tmp_dir, ignore_errors=True)
    with open(os.path.join(directory, "latest.tmp"), "w") as f:
        f.write(os.path.basename(ckpt_dir))
    os.replace(os.path.join(directory, "latest.tmp"),
               os.path.join(directory, "latest"))
    return ckpt_dir


def _read_pointer(directory: str, pointer_name: str) -> Optional[str]:
    pointer = os.path.join(directory, pointer_name)
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    path = os.path.join(directory, name)
    return path if os.path.exists(path) else None


def latest_checkpoint(directory: str) -> Optional[str]:
    return _read_pointer(directory, "latest")


def best_checkpoint(directory: str) -> Optional[str]:
    """The checkpoint the `best` pointer names (see
    `CheckpointManager.mark_best`), or None."""
    return _read_pointer(directory, "best")


def _as_leaf(arr: np.ndarray, dtype: str, like):
    """A stored array as a leaf of `like`'s kind (a tensor on `like`'s
    device, or an array)."""
    if not isinstance(like, torch.Tensor):
        return arr
    t = torch.from_numpy(np.array(arr))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def restore_checkpoint(path: str, state_like: Tree, *,
                       verify: bool = True) -> tuple[int, Tree, dict]:
    """(step, state, extra): the checkpoint at `path` restored into the
    structure of `state_like`; with `verify`, every array's sha1 is
    checked first (IOError "corrupt checkpoint" on a mismatch)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    leaves = []
    for name, like in _leaves_with_names(state_like):
        meta = manifest["arrays"][name]
        arr = arrays[f"a{meta['index']}"]
        if verify:
            digest = hashlib.sha1(
                np.ascontiguousarray(arr).tobytes()).hexdigest()
            if digest != meta["sha1"]:
                raise IOError(f"checksum mismatch for {name} "
                              f"(corrupt checkpoint {path})")
        leaves.append(_as_leaf(arr, meta["dtype"], like))
    state = _unflatten(state_like, iter(leaves))
    return manifest["step"], state, manifest.get("extra", {})


class CheckpointManager:
    """Async checkpointing + retention + preemption hook."""

    def __init__(self, directory: str, *, keep: int = 3,
                 save_interval_steps: int = 100):
        self.directory = directory
        self.keep = keep
        self.save_interval_steps = save_interval_steps
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._preempted = False

    def install_preemption_hook(self, get_state: Callable[[], tuple]):
        """On SIGTERM, save ``get_state() -> (step, state, extra)`` at
        once (from the main thread only; elsewhere this does nothing)."""
        def handler(signum, frame):
            self._preempted = True
            step, state, extra = get_state()
            save_checkpoint(self.directory, step, state, extra=extra)
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not the main thread

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval_steps == 0

    def save_async(self, step: int, state: Tree, *,
                   extra: dict | None = None) -> None:
        """Copy `state` to the host now, on the calling thread (the
        optimizer updates the parameters in place afterwards), then write
        it on a background thread; one write in flight at a time."""
        self.wait()
        copy = host_state(state)

        def work():
            # failures are re-raised from wait() on the training thread,
            # not leaked as unraisable thread exceptions
            try:
                _write(self.directory, step, copy, extra)
                self._gc()
            except BaseException as exc:  # noqa: BLE001 — re-raised from
                #                            wait()/close() on the
                #                            training thread
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self):
        """Join the in-flight writer (if any) and surface its error; after
        close() no ckpt-writer thread is alive."""
        self.wait()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def mark_best(self, step: int) -> None:
        """Point the `best` pointer at ``step``'s checkpoint (atomic; the
        named checkpoint is then exempt from retention GC).  Call after
        the step's save has landed (`wait()`)."""
        name = f"step_{step:010d}"
        if not os.path.isdir(os.path.join(self.directory, name)):
            raise FileNotFoundError(
                f"mark_best({step}): no checkpoint {name} in "
                f"{self.directory} (save and wait() first)")
        with open(os.path.join(self.directory, "best.tmp"), "w") as f:
            f.write(name)
        os.replace(os.path.join(self.directory, "best.tmp"),
                   os.path.join(self.directory, "best"))

    def _gc(self):
        if not os.path.isdir(self.directory):
            return
        best = best_checkpoint(self.directory)
        best_name = os.path.basename(best) if best else None
        ckpts = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for old in ckpts[:-self.keep]:
            if old == best_name:  # the best pointer pins its target
                continue
            shutil.rmtree(os.path.join(self.directory, old),
                          ignore_errors=True)

    def restore_latest(self, state_like: Tree):
        path = latest_checkpoint(self.directory)
        if path is None:
            return None
        return restore_checkpoint(path, state_like)

    def restore_best(self, state_like: Tree):
        path = best_checkpoint(self.directory)
        if path is None:
            return None
        return restore_checkpoint(path, state_like)
