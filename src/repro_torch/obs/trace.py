"""Structured trace spans — a bounded ring recorder with Perfetto export.

Port of ``repro.obs.trace``.

The engine wraps staging, every update sweep (annotated with that sweep's
physical ``bytes_h2d``/``bytes_disk_read`` deltas and active-interval
count) and each run in spans recorded here.
The ring (:class:`Tracer`) is lock-free-ish: spans are immutable tuples
appended to a ``collections.deque(maxlen=capacity)`` (atomic under the
GIL), with one tiny lock only around the thread-label table — recording
never blocks the sweep loop on another thread's export.

Export is Chrome/Perfetto ``trace_event`` JSON (``ph="X"`` complete
events, microsecond timestamps, ``M``-phase thread-name metadata), loadable
directly in https://ui.perfetto.dev. ``python -m repro_torch.obs export-trace``
converts a raw ``.jsonl`` span dump into the same format offline.

Tracing is **off by default** — the disabled path is one attribute check
per gate site, which is what keeps the engine's no-trace overhead within
a small share of a sweep. Enable process-wide with :func:`enable_tracing`, or
per run with the :class:`TraceSpec` plan knob
(``ExecutionPlan(trace=TraceSpec(path="run.json"))``), which turns the
recorder on for that run's duration and writes its spans on completion.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import threading
import time

__all__ = [
    "Span",
    "TraceSpec",
    "Tracer",
    "TRACER",
    "enable_tracing",
    "disable_tracing",
]


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """The tracing axis of an :class:`~repro_torch.core.plan.ExecutionPlan`.

    Args:
      path: where to write this run's spans when it completes — Chrome
        ``trace_event`` JSON by default, or a raw one-span-per-line
        ``.jsonl`` dump when the path ends in ``.jsonl`` (convertible
        offline via ``python -m repro_torch.obs export-trace``). ``None``
        records into the process ring without exporting.
      sweeps: record one span per update sweep (with per-sweep byte
        deltas); ``False`` keeps only the run and staging spans.

    The knob is observational: it deliberately does **not** participate in
    ``plan.batch_key()``, so traced and untraced requests still fuse (a
    fused batch records under the first member's spec).
    """

    path: str | None = None
    sweeps: bool = True


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed span (seconds; ``ts`` is ``time.perf_counter`` based)."""

    seq: int
    name: str
    cat: str
    ts: float
    dur: float
    tid: int
    args: tuple  # sorted (key, value) pairs — kept hashable/immutable

    def args_dict(self) -> dict:
        return dict(self.args)


def _freeze_args(args: dict | None) -> tuple:
    if not args:
        return ()
    return tuple(sorted(args.items()))


class Tracer:
    """Bounded in-process span recorder.

    ``record``/``instant`` append unconditionally — *callers* gate on
    ``tracer.enabled`` (one branch) so the disabled path never builds an
    args dict. The ``span`` context manager gates itself and is the
    convenient form for non-hot call sites.
    """

    def __init__(self, capacity: int = 65536):
        self.enabled = False
        self._ring: collections.deque[Span] = collections.deque(
            maxlen=capacity
        )
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._tids: dict[str, int] = {}

    # -- recording -----------------------------------------------------------
    def tid_for(self, label: str | None = None) -> int:
        """Stable small integer for a logical track (default: this thread)."""
        if label is None:
            label = threading.current_thread().name
        tid = self._tids.get(label)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(label, len(self._tids) + 1)
        return tid

    def record(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        cat: str = "repro",
        tid_label: str | None = None,
        args: dict | None = None,
    ) -> None:
        """Append one completed span (caller supplies perf_counter times)."""
        self._ring.append(
            Span(
                seq=next(self._seq),
                name=name,
                cat=cat,
                ts=t0,
                dur=max(t1 - t0, 0.0),
                tid=self.tid_for(tid_label),
                args=_freeze_args(args),
            )
        )

    def instant(
        self,
        name: str,
        *,
        cat: str = "repro",
        tid_label: str | None = None,
        args: dict | None = None,
    ) -> None:
        now = time.perf_counter()
        self.record(name, now, now, cat=cat, tid_label=tid_label, args=args)

    def span(self, name: str, *, cat: str = "repro", **args):
        """Context manager; records on exit iff the tracer is enabled."""
        return _SpanCtx(self, name, cat, args)

    # -- access / export -----------------------------------------------------
    def mark(self) -> int:
        """A position token; pass to ``spans``/``export`` as ``since``."""
        return next(self._seq)

    def spans(self, since: int = 0) -> list[Span]:
        return [s for s in list(self._ring) if s.seq >= since]

    def clear(self) -> None:
        self._ring.clear()

    def _tid_labels(self) -> dict[int, str]:
        with self._lock:
            return {tid: label for label, tid in self._tids.items()}

    def to_chrome(self, since: int = 0) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object for the recorded spans."""
        labels = self._tid_labels()
        events = [
            {
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "name": "thread_name",
                "args": {"name": label},
            }
            for tid, label in sorted(labels.items())
        ]
        for s in self.spans(since):
            events.append(
                {
                    "name": s.name,
                    "cat": s.cat,
                    "ph": "X",
                    "pid": 1,
                    "tid": s.tid,
                    "ts": s.ts * 1e6,
                    "dur": s.dur * 1e6,
                    "args": s.args_dict(),
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str, since: int = 0) -> str:
        """Write spans to ``path`` — Chrome JSON, or raw jsonl for ``.jsonl``."""
        if path.endswith(".jsonl"):
            return self.dump(path, since=since)
        with open(path, "w") as fh:
            json.dump(self.to_chrome(since), fh)
        return path

    def dump(self, path: str, since: int = 0) -> str:
        """Raw one-span-per-line dump (offline-convertible, append-friendly)."""
        labels = self._tid_labels()
        with open(path, "w") as fh:
            for s in self.spans(since):
                fh.write(
                    json.dumps(
                        {
                            "name": s.name,
                            "cat": s.cat,
                            "ts": s.ts,
                            "dur": s.dur,
                            "tid": s.tid,
                            "tlabel": labels.get(s.tid, str(s.tid)),
                            "args": s.args_dict(),
                        }
                    )
                    + "\n"
                )
        return path


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0", "_live")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0.0
        self._live = False

    def __enter__(self):
        self._live = self._tracer.enabled
        if self._live:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._live:
            self._tracer.record(
                self._name,
                self._t0,
                time.perf_counter(),
                cat=self._cat,
                args=self._args,
            )
        return False


#: The process-global tracer every repro subsystem records into.
TRACER = Tracer()


def enable_tracing(capacity: int | None = None) -> Tracer:
    """Turn the process tracer on (optionally resizing its ring in place —
    modules hold direct references to :data:`TRACER`, so it is never
    replaced)."""
    if capacity is not None and capacity != TRACER._ring.maxlen:
        TRACER._ring = collections.deque(TRACER._ring, maxlen=capacity)
    TRACER.enabled = True
    return TRACER


def disable_tracing() -> Tracer:
    TRACER.enabled = False
    return TRACER
