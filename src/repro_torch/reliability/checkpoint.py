"""Sweep-level checkpoint/resume for iterative engine runs (port of
``repro.reliability.checkpoint``: the same file names, array names and
metadata, so a snapshot written by either package resumes in the other).

A 100-iteration PageRank killed at sweep 99 should not restart from zero.
:class:`CheckpointSpec` is the plan axis (``ExecutionPlan(checkpoint=...)``)
that makes :meth:`GraphSession._execute` atomically snapshot the full
iteration state — vertex attributes for every fused query, the activity
bitmaps, the per-query convergence sweeps, the activity log, and the
cumulative :class:`~repro_torch.core.session.Meters` — every ``every`` sweeps.

Snapshots are single ``.npz`` files written tmp → flush → fsync →
``os.replace`` → fsync(dir), so a crash at any instant leaves either the
previous complete snapshot or the new complete snapshot, never a torn
one. Keep-N pruning happens *after* publish and is derived purely from
the filename pattern (``sweep_%08d.npz``) — there is no separate index
file to orphan, so pruning is crash-safe by construction.

``session.run(plan, resume_from=...)`` restores the snapshot and
continues the loop; the contract (enforced by the chaos suite) is
bit-identical results and field-identical cumulative meters vs the
uninterrupted run — wall_seconds excepted, which accumulates real elapsed
time across attempts.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch.obs.registry import REGISTRY as _REGISTRY

_OBS_SAVES = _REGISTRY.counter(
    "repro_checkpoint_saves_total", "Checkpoint snapshots published"
)
_OBS_SAVE_BYTES = _REGISTRY.counter(
    "repro_checkpoint_bytes_total", "Bytes of published checkpoint snapshots"
)

__all__ = [
    "CheckpointSpec",
    "SnapshotError",
    "latest_snapshot",
    "list_snapshots",
    "load_snapshot",
    "save_snapshot",
    "snapshot_path",
]

_PATTERN = "sweep_%08d.npz"
_META_KEY = "__meta_json__"


class SnapshotError(RuntimeError):
    """A snapshot is unreadable or does not match the resuming plan."""


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    """The checkpoint axis of an :class:`~repro_torch.core.plan.ExecutionPlan`.

    Args:
      directory: where snapshots land (created on first save).
      every: snapshot cadence in sweeps (after every ``every``-th sweep).
      keep: how many most-recent snapshots survive pruning.
    """

    directory: str
    every: int = 1
    keep: int = 2

    def __post_init__(self):
        if not self.directory:
            raise ValueError("checkpoint directory must be non-empty")
        if self.every < 1:
            raise ValueError(f"checkpoint every must be >= 1, got {self.every}")
        if self.keep < 1:
            raise ValueError(f"checkpoint keep must be >= 1, got {self.keep}")


def snapshot_path(directory: str, sweep: int) -> str:
    return os.path.join(directory, _PATTERN % sweep)


def list_snapshots(directory: str) -> list[str]:
    """Complete snapshots in ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    names = [
        n
        for n in os.listdir(directory)
        if n.startswith("sweep_") and n.endswith(".npz")
    ]
    return [os.path.join(directory, n) for n in sorted(names)]


def latest_snapshot(directory: str) -> str | None:
    snaps = list_snapshots(directory)
    return snaps[-1] if snaps else None


def save_snapshot(
    directory: str,
    sweep: int,
    arrays: dict[str, np.ndarray],
    meta: dict,
    *,
    keep: int = 2,
) -> str:
    """Atomically publish one snapshot; prune to the newest ``keep``.

    The payload hits disk (flush + fsync) before ``os.replace`` makes it
    visible under its final name, and the directory is fsynced after the
    rename so the publish itself survives a crash. Returns the final path.
    """
    os.makedirs(directory, exist_ok=True)
    final = snapshot_path(directory, sweep)
    tmp = final + ".tmp"
    payload = dict(arrays)
    if _META_KEY in payload:
        raise ValueError(f"array name {_META_KEY!r} is reserved")
    payload[_META_KEY] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode("utf-8"), dtype=np.uint8
    )
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, final)
    dirfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
    _OBS_SAVES.inc()
    _OBS_SAVE_BYTES.inc(os.path.getsize(final))
    # Prune after publish: the new snapshot is durable before any old one
    # dies, so a crash anywhere in here leaves >= keep restorable states.
    snaps = list_snapshots(directory)
    for stale in snaps[:-keep] if keep else snaps:
        if stale != final:
            os.unlink(stale)
    # Orphaned tmp files from crashed saves are dead weight — sweep them.
    for name in os.listdir(directory):
        if name.endswith(".npz.tmp"):
            os.unlink(os.path.join(directory, name))
    return final


def load_snapshot(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Read one snapshot back as ``(arrays, meta)``."""
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files if k != _META_KEY}
            if _META_KEY not in z.files:
                raise SnapshotError(f"{path}: missing snapshot metadata")
            meta = json.loads(bytes(z[_META_KEY]).decode("utf-8"))
    except (OSError, ValueError) as exc:
        raise SnapshotError(f"{path}: unreadable snapshot: {exc}") from exc
    return arrays, meta
