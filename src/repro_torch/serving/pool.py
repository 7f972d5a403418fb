"""Multi-graph session pool with explicit staged-bytes capacity (port of
``repro.serving.pool``).

Evolves the module-level ``get_session`` LRU into a first-class object the
server can do admission control against: each registered graph (an
in-memory :class:`~repro_torch.core.dsss.DSSSGraph` or a ``.dsss`` path) opens
lazily into a :class:`~repro_torch.core.session.GraphSession`, the pool accounts
the host RAM each open session's staged buffers occupy
(:meth:`GraphSession.staged_host_bytes`), and least-recently-used idle
sessions are evicted when ``capacity_bytes`` / ``max_open`` would be
exceeded. Evicting a path-registered graph is cheap to undo — the next
query pages it back in from the ``.dsss`` container via
:meth:`GraphSession.open` (mmap views, nothing edge-scale in RAM);
object-registered graphs restage from the in-memory arrays.

Sessions with in-flight work are pinned (``acquire``/``release`` refcount)
and never evicted mid-run. All entry state is guarded by one reentrant
lock, so pin/evict/open races from the server's executor threads can't
interleave: ``acquire`` opens-and-pins atomically (no window where a
fresh session is evictable before its pin lands), and a concurrent
double-open of a cold entry can't strand a second staged copy's bytes.

Per-graph **circuit breaker**: when ``breaker_threshold`` consecutive
failures are recorded against a graph (:meth:`record_failure`), its
breaker opens and ``acquire`` sheds with :class:`CircuitOpenError` for
``breaker_cooldown_s`` — a persistently failing graph stops burning
executor slots and retry budgets. After the cooldown one trial request is
let through (half-open); :meth:`record_success` closes the breaker and
clears the failure count, while a trial failure re-trips it immediately
(the count is retained across the half-open transition).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any

from repro_torch.core.dsss import DSSSGraph
from repro_torch.core.session import GraphSession
from repro_torch.obs.registry import REGISTRY as _REGISTRY

_OBS_BREAKER_TRIPS = _REGISTRY.counter(
    "repro_pool_breaker_trips_total",
    "Circuit breakers (re-)tripped by consecutive failures",
)

__all__ = ["CircuitOpenError", "PoolStats", "SessionPool"]


class CircuitOpenError(RuntimeError):
    """The graph's circuit breaker is open — request shed, not run."""


@dataclasses.dataclass
class PoolStats:
    """Snapshot of the pool's staging ledger."""

    registered: int = 0
    open_sessions: int = 0
    staged_bytes: int = 0  # host RAM of all open sessions' staged buffers
    capacity_bytes: int | None = None
    opens: int = 0  # sessions staged (first open or re-open after evict)
    evictions: int = 0
    hits: int = 0  # session() calls served by an already-open session
    breakers_open: int = 0  # graphs currently shedding via CircuitOpenError

    def to_metrics(self, registry=None) -> None:
        """Publish this snapshot (snapshot-set, like ``ServerStats``)."""
        from repro_torch.obs.registry import REGISTRY

        reg = registry if registry is not None else REGISTRY
        for f in ("registered", "open_sessions", "staged_bytes",
                  "breakers_open"):
            reg.gauge(f"repro_pool_{f}", f"PoolStats.{f} snapshot").set(
                getattr(self, f)
            )
        for f in ("opens", "evictions", "hits"):
            reg.counter(
                f"repro_pool_{f}_total", f"PoolStats.{f} snapshot"
            ).set(getattr(self, f))


@dataclasses.dataclass
class _Entry:
    name: str
    source: Any  # DSSSGraph | str (.dsss path)
    kwargs: dict
    session: GraphSession | None = None
    in_use: int = 0
    failures: int = 0  # consecutive failures since the last success
    open_until: float = 0.0  # monotonic deadline while the breaker is open


class SessionPool:
    """Named graphs → lazily opened, capacity-bounded ``GraphSession``\\ s.

    Args:
      capacity_bytes: bound on the summed
        :meth:`~repro_torch.core.session.GraphSession.staged_host_bytes` of open
        sessions. ``None`` = unbounded. The bound is enforced by evicting
        idle LRU sessions *before* each open; a single graph larger than
        the capacity still opens (it alone defines the working set) —
        mirroring ``memory_budget`` semantics, where the budget shapes
        residency rather than refusing the graph.
      max_open: bound on simultaneously open sessions (the old
        ``get_session`` LRU's size-8 analogue).
      breaker_threshold: consecutive :meth:`record_failure` calls on one
        graph before its breaker opens (``None`` disables the breaker).
      breaker_cooldown_s: how long an open breaker sheds before letting a
        half-open trial through.
    """

    def __init__(
        self,
        *,
        capacity_bytes: int | None = None,
        max_open: int = 8,
        breaker_threshold: int | None = None,
        breaker_cooldown_s: float = 30.0,
    ):
        if breaker_threshold is not None and breaker_threshold < 1:
            raise ValueError("breaker_threshold must be ≥ 1 (or None)")
        if breaker_cooldown_s < 0:
            raise ValueError("breaker_cooldown_s must be ≥ 0")
        self.capacity_bytes = capacity_bytes
        self.max_open = max_open
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._opens = 0
        self._evictions = 0
        self._hits = 0

    # -- registration --------------------------------------------------------
    def register(self, name: str, source, **session_kwargs) -> str:
        """Register a graph under ``name``.

        ``source`` is a ``DSSSGraph`` (staged in-memory on open) or a
        ``str`` path to a ``.dsss`` container (opened disk-backed via
        :meth:`GraphSession.open`; cold graphs page in from the file).
        ``session_kwargs`` (device, memory_budget, host_memory_budget,
        residency, execution, packing, Be, Bv) are applied at every
        (re-)open. ``device`` goes to the session as given: the pool never
        picks one, so without it the session's default (the CUDA card)
        holds.
        """
        if not isinstance(source, (DSSSGraph, str)):
            raise TypeError(
                "source must be a DSSSGraph or a .dsss path, "
                f"got {type(source).__name__}"
            )
        with self._lock:
            if name in self._entries:
                raise ValueError(f"graph {name!r} already registered")
            self._entries[name] = _Entry(
                name=name, source=source, kwargs=session_kwargs
            )
        return name

    def ensure(self, graph: DSSSGraph, **session_kwargs) -> str:
        """Auto-register an anonymous graph object by identity (idempotent).

        The pool holds a strong reference to the graph for the entry's
        lifetime — use :meth:`register` with an explicit name (or a
        ``.dsss`` path) for long-lived servers.
        """
        kw_tag = hash(tuple(sorted(session_kwargs.items()))) & 0xFFFF
        # id() is unique among live objects and the entry holds a strong
        # reference, so an existing entry under this name is this graph.
        name = f"graph@{id(graph):x}/{kw_tag:04x}"
        with self._lock:
            if name not in self._entries:
                self.register(name, graph, **session_kwargs)
        return name

    def resolve(self, graph) -> str:
        """Normalize a request's ``graph`` field to a pool key."""
        if isinstance(graph, str):
            with self._lock:
                if graph not in self._entries:
                    raise KeyError(f"graph {graph!r} is not registered")
            return graph
        if isinstance(graph, DSSSGraph):
            return self.ensure(graph)
        raise TypeError(
            "QueryRequest.graph must be a registered name or a DSSSGraph, "
            f"got {type(graph).__name__}"
        )

    def names(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    # -- access --------------------------------------------------------------
    def session(self, name: str) -> GraphSession:
        """The (opened) session for ``name``; LRU-bumps the entry."""
        with self._lock:
            entry = self._entries[name]
            if entry.session is None:
                self._open(entry)
            else:
                self._hits += 1
            self._entries.move_to_end(name)
            return entry.session

    def acquire(self, name: str) -> GraphSession:
        """Like :meth:`session`, and pins the entry against eviction.

        Open-and-pin is atomic under the pool lock — a concurrent
        ``_evict_to_fit`` can never observe the freshly opened session
        with a zero refcount and evict it out from under the caller.
        Sheds with :class:`CircuitOpenError` while the graph's breaker is
        open; after ``breaker_cooldown_s`` one trial acquire is let
        through (half-open — the failure count is retained so a failed
        trial re-trips instantly).
        """
        with self._lock:
            entry = self._entries[name]
            if entry.open_until:
                if time.monotonic() < entry.open_until:
                    raise CircuitOpenError(
                        f"graph {name!r}: circuit open after "
                        f"{entry.failures} consecutive failures "
                        f"(cooldown {self.breaker_cooldown_s}s)"
                    )
                entry.open_until = 0.0  # half-open: let one trial through
            session = self.session(name)
            entry.in_use += 1
            return session

    def release(self, name: str) -> None:
        with self._lock:
            entry = self._entries[name]
            if entry.in_use <= 0:
                raise RuntimeError(f"release() without acquire() for {name!r}")
            entry.in_use -= 1
            # The unpin may make this entry the eviction candidate the
            # pool has been waiting for; re-enforce the bounds now rather
            # than leaving stale staged bytes resident until the next
            # open. (Never evicts still-pinned or just-released-but-
            # re-acquired entries — the refcount is authoritative.)
            self._evict_to_fit(keep="")

    def evict(self, name: str) -> bool:
        """Drop ``name``'s open session (no-op if cold or in use)."""
        with self._lock:
            entry = self._entries[name]
            if entry.session is None or entry.in_use > 0:
                return False
            entry.session = None
            self._evictions += 1
            return True

    # -- circuit breaker -----------------------------------------------------
    def record_failure(self, name: str) -> bool:
        """Count one failed run against ``name``; returns True if the
        breaker (re-)tripped."""
        with self._lock:
            entry = self._entries[name]
            entry.failures += 1
            if (
                self.breaker_threshold is not None
                and entry.failures >= self.breaker_threshold
            ):
                entry.open_until = time.monotonic() + self.breaker_cooldown_s
                _OBS_BREAKER_TRIPS.inc()
                return True
            return False

    def record_success(self, name: str) -> None:
        """A run on ``name`` succeeded — close its breaker, reset the count."""
        with self._lock:
            entry = self._entries[name]
            entry.failures = 0
            entry.open_until = 0.0

    def breaker_open(self, name: str) -> bool:
        with self._lock:
            return time.monotonic() < self._entries[name].open_until

    # -- accounting ----------------------------------------------------------
    def staged_bytes(self) -> int:
        """Summed host RAM of every open session's staged buffers (live —
        disk-backed sessions grow as their RAM caches materialize)."""
        with self._lock:
            return sum(
                int(e.session.staged_host_bytes())
                for e in self._entries.values()
                if e.session is not None
            )

    def stats(self) -> PoolStats:
        with self._lock:
            now = time.monotonic()
            return PoolStats(
                registered=len(self._entries),
                open_sessions=sum(
                    1 for e in self._entries.values() if e.session is not None
                ),
                staged_bytes=self.staged_bytes(),
                capacity_bytes=self.capacity_bytes,
                opens=self._opens,
                evictions=self._evictions,
                hits=self._hits,
                breakers_open=sum(
                    1 for e in self._entries.values() if now < e.open_until
                ),
            )

    # -- internals (callers hold self._lock) ---------------------------------
    def _open(self, entry: _Entry) -> None:
        if isinstance(entry.source, str):
            entry.session = GraphSession.open(entry.source, **entry.kwargs)
        else:
            entry.session = GraphSession(entry.source, **entry.kwargs)
        self._opens += 1
        self._evict_to_fit(keep=entry.name)

    def _evict_to_fit(self, keep: str) -> None:
        """Evict idle LRU sessions until capacity/max_open hold.

        The just-opened ``keep`` entry is never evicted: one graph larger
        than the capacity runs alone rather than thrashing. Pinned entries
        (``in_use > 0``) are likewise never victims — when everything
        evictable is pinned the bounds are temporarily exceeded and
        :meth:`release` re-enforces them as pins drop.
        """

        def over() -> bool:
            n_open = sum(
                1 for e in self._entries.values() if e.session is not None
            )
            if n_open > self.max_open:
                return True
            return (
                self.capacity_bytes is not None
                and self.staged_bytes() > self.capacity_bytes
            )

        while over():
            victim = next(
                (
                    e
                    for e in self._entries.values()  # LRU order
                    if e.session is not None and e.in_use == 0 and e.name != keep
                ),
                None,
            )
            if victim is None:
                break  # everything else is in use — nothing evictable
            self.evict(victim.name)
