"""Checkpointing: npz payload + JSON manifest, async save, keep-N, restore.

Port of the JAX package's ``repro.checkpoint.manager``, with its files:
``step_{step:010d}/arrays.npz`` holds the state's arrays as ``a{i}`` in the
reference's flatten order (dict keys sorted, lists in order, ``None``
skipped), beside ``manifest.json``. A state laid out as the reference's
tree (``repro_torch.train.state.checkpoint_tree``) therefore writes the
files the JAX package writes, and each package restores the other's.

* Saves run on a background thread that gets a host copy of every array
  first, so training may go on changing the tensors.
* Publishing is atomic: payload and manifest are fsynced in a tmp
  directory, a superseded step is renamed aside (never deleted in place)
  before its replacement is renamed into place, and the directory is
  fsynced. ``all_steps`` counts only complete step directories; the next
  save's garbage collection sweeps orphaned tmp/trash/partial directories
  from a crash and keeps the ``keep`` newest steps.
* Restore checks the count and every shape against a template and raises
  on a mismatch.

One change from the reference: ``all_steps`` (and so ``latest_step``)
first waits for this manager's save in flight. The reference lists the
directory at once, so its loop, failing while a large checkpoint is still
being written, restarts from an older step or from scratch.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

__all__ = ["CheckpointManager"]


def _flatten(tree) -> list:
    """Leaves in the reference's order: dict keys sorted, lists and tuples
    in order, ``None`` skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in :func:`_flatten` order."""
    it = iter(leaves)

    def rebuild(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)

    return rebuild(tree)


def _structure(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def _host(x) -> np.ndarray:
    """A host copy (numpy has no bfloat16: it becomes float32, exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy().copy()
    return np.array(x)


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        dtype = torch.float32 if dtype == torch.bfloat16 else dtype
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state, *, block: bool = False) -> None:
        """Snapshot ``state`` (nested dicts and lists of tensors or arrays) at ``step``."""
        flat = _flatten(state)
        # A host copy NOW, so training can change the tensors while the
        # writer thread runs.
        host_flat = [_host(x) for x in flat]
        structure = _structure(state)
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_flat, structure), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, host_flat, structure)

    def _write(self, step: int, host_flat, structure: str) -> None:
        tmp = os.path.join(self.directory, f".tmp_step_{step}")
        final = os.path.join(self.directory, f"step_{step:010d}")
        trash = os.path.join(self.directory, f".trash_step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)  # stale leftover from a crashed save
        os.makedirs(tmp)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **{f"a{i}": a for i, a in enumerate(host_flat)})
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "num_arrays": len(host_flat), "treedef": structure}, f)
            f.flush()
            os.fsync(f.fileno())
        # Publish: move a superseded step ASIDE (rename is atomic; rmtree
        # is not) so no crash point leaves us without a complete copy of
        # this step, then swing the tmp dir into place and fsync the
        # parent so the renames are durable.
        if os.path.exists(trash):
            shutil.rmtree(trash)
        if os.path.exists(final):
            os.rename(final, trash)
        os.rename(tmp, final)  # atomic publish
        self._fsync_dir(self.directory)
        if os.path.exists(trash):
            shutil.rmtree(trash)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _fsync_dir(path: str) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        except OSError:
            pass  # some filesystems refuse directory fsync
        finally:
            os.close(fd)

    def _complete(self, name: str) -> bool:
        d = os.path.join(self.directory, name)
        return os.path.exists(os.path.join(d, "arrays.npz")) and os.path.exists(
            os.path.join(d, "manifest.json")
        )

    def _gc(self) -> None:
        # Sweep crash debris first: orphaned tmp/trash dirs and published
        # step dirs missing their payload (a rmtree interrupted mid-prune).
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.startswith((".tmp_step_", ".trash_step_")):
                shutil.rmtree(path, ignore_errors=True)
            elif name.startswith("step_") and not self._complete(name):
                shutil.rmtree(path, ignore_errors=True)
        steps = self._steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"))

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        """Steps with a *complete* (payload + manifest) directory — a
        crash-truncated directory is never offered for restore. A save of
        this manager still being written is waited for first (the
        reference lists without waiting, so a restore right after a large
        async save misses it)."""
        self.wait()
        return self._steps()

    def _steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and self._complete(name):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: int | None = None):
        """Restore into the structure of ``like``, a template whose leaves
        have the arrays' shapes and dtypes (tensors, also on the ``meta``
        device, or numpy arrays). Returns ``(tree, step)``, the tree's leaves
        numpy arrays in the template's dtypes (the caller places them).
        """
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:010d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = [z[f"a{i}"] for i in range(len(z.files))]
        like_flat = _flatten(like)
        if len(like_flat) != len(flat):
            raise ValueError(
                f"checkpoint has {len(flat)} arrays, template expects "
                f"{len(like_flat)} — architecture mismatch?"
            )
        out = []
        for tmpl, arr in zip(like_flat, flat):
            a = np.asarray(arr)
            if tuple(a.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch {a.shape} vs {tuple(tmpl.shape)} on restore")
            out.append(a.astype(_np_dtype(tmpl.dtype)))
        return _unflatten(like, out), step
