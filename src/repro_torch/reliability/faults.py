"""Deterministic fault injection for every layer that moves data (port of
``repro.reliability.faults``; stdlib only, the same labels, coins and budgets).

Production graph serving fails in boring, repeatable ways — torn disk
reads, transient H2D transfer errors, stalled devices, killed processes —
and a reliability layer is only trustworthy if those failures can be
*reproduced on demand*. This module is the single injection API:

* :class:`FaultPlan` — a frozen, seedable description of which faults fire
  where. Specs target the real I/O boundaries by *site*:

  - ``"storage"`` — the ``.dsss`` segment verification reads in
    :mod:`repro_torch.storage.format` (``corrupt`` / ``short`` torn reads,
    cleared after ``times`` re-reads or persistent with ``times=None``);
  - ``"h2d"`` — the host→device copies of streamed edge topology: the
    per-block upload in ``_BlockFetcher`` (label ``"block:i,j"``) and the
    packed chunk's copy into the ring (label ``"chunk:lo"``, ``lo`` the
    chunk's first tile); ``transient`` errors, ``stall`` sleeps;
  - ``"sweep"`` — crash-at-sweep-N in the engine loop
    (:meth:`GraphSession._execute`);
  - ``"step"`` — the train-loop step injection the old
    ``runtime.fault.FailureInjector`` provided (a re-export shim over
    this module).

* :class:`FaultInjector` — the live, counting instance a plan builds
  (``plan.injector()``). Sessions and stores share one injector so fire
  budgets are accounted once across layers.

Determinism: rate-based specs draw from a counter-hashed ``zlib.crc32``
stream of ``(seed, spec, occurrence)`` — the same plan against the same
deterministic call sequence fires at exactly the same events, so chaos
tests are replayable and bit-identity oracles stay meaningful.

Exception taxonomy: :class:`SimulatedFailure` (the legacy train-loop name)
is the base of every injected fault; :class:`InjectedCrash` models process
death (recover by resuming from a checkpoint), :class:`TransientFault`
models a retryable I/O error (recover by retrying the transfer / the
batch). :class:`DeadlineExceeded` is *not* a fault — it is the cooperative
between-sweep cancellation signal the serving deadline machinery raises.
"""
from __future__ import annotations

import dataclasses
import time
import zlib

from repro_torch.obs.registry import REGISTRY as _REGISTRY

_OBS_RETRIES = _REGISTRY.counter(
    "repro_transient_retries_total",
    "Transient-fault retries at transfer boundaries",
    ("site",),
)
_OBS_RETRIES_H2D = _OBS_RETRIES.labels(site="h2d")

__all__ = [
    "DeadlineExceeded",
    "FailureInjector",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "InjectedCrash",
    "SimulatedFailure",
    "StepTimer",
    "StragglerWatchdog",
    "TransientFault",
    "elastic_device_count",
    "with_transient_retries",
]


class SimulatedFailure(RuntimeError):
    """Base of every injected fault (the legacy train-loop name)."""


class InjectedCrash(SimulatedFailure):
    """An injected process-death analogue (recover via checkpoint/resume)."""


class TransientFault(SimulatedFailure):
    """An injected retryable I/O error (recover via bounded retry)."""


class DeadlineExceeded(RuntimeError):
    """A request's deadline passed — cooperative between-sweep cancellation."""


_SITES = ("storage", "h2d", "sweep", "step")
_KINDS = ("crash", "transient", "stall", "corrupt", "short")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault rule: where it fires, what it does, and how often.

    Args:
      site: injection boundary — one of ``"storage"``, ``"h2d"``,
        ``"sweep"``, ``"step"``.
      kind: what happens on a hit — ``"crash"`` raises
        :class:`InjectedCrash`, ``"transient"`` raises
        :class:`TransientFault`, ``"stall"`` sleeps ``stall_s``,
        ``"corrupt"``/``"short"`` (storage site) make the verification
        read observe flipped / truncated bytes.
      at: fire exactly at these integer identities (sweep / step numbers).
      match: substring filter on string identities (segment names, h2d
        transfer labels like ``"block:0,1"`` / ``"chunk:64"``); ``""``
        matches everything.
      rate: per-occurrence probability, drawn deterministically from the
        plan seed. ``0.0`` with empty ``at`` means "every matching event".
      times: total fire budget (``None`` = unlimited / persistent). For
        storage specs this is the number of consecutive *attempts* that
        observe the bad bytes — a torn read that clears after re-reads.
      stall_s: sleep duration for ``kind="stall"``.
    """

    site: str
    kind: str = "crash"
    at: tuple[int, ...] = ()
    match: str = ""
    rate: float = 0.0
    times: int | None = 1
    stall_s: float = 0.0

    def __post_init__(self):
        if self.site not in _SITES:
            raise ValueError(f"site must be one of {_SITES}, got {self.site!r}")
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.times is not None and self.times < 1:
            raise ValueError(f"times must be >= 1 or None, got {self.times}")
        object.__setattr__(self, "at", tuple(int(s) for s in self.at))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A frozen, seedable set of fault rules; ``injector()`` makes it live."""

    specs: tuple[FaultSpec, ...] = ()
    seed: int = 0

    def __post_init__(self):
        specs = tuple(self.specs)
        for s in specs:
            if not isinstance(s, FaultSpec):
                raise TypeError(
                    f"specs must be FaultSpec instances, got {type(s).__name__}"
                )
        object.__setattr__(self, "specs", specs)

    # -- convenience constructors -------------------------------------------
    @classmethod
    def crash_at_sweep(cls, sweep: int, *, seed: int = 0) -> "FaultPlan":
        """Kill the engine loop right before executing sweep ``sweep``
        (``sweep`` update sweeps have completed when it fires; fires once,
        so a resumed run proceeds)."""
        return cls(specs=(FaultSpec(site="sweep", at=(sweep,)),), seed=seed)

    @classmethod
    def crash_at_step(cls, *steps: int, seed: int = 0) -> "FaultPlan":
        """The train-loop injection: crash at the given step numbers."""
        return cls(
            specs=(FaultSpec(site="step", at=tuple(steps), times=len(steps)),),
            seed=seed,
        )

    @classmethod
    def h2d_transient(
        cls, *, rate: float = 0.0, times: int | None = 1,
        match: str = "", seed: int = 0,
    ) -> "FaultPlan":
        """Transient host→device transfer errors (``rate=0`` = every
        matching transfer, until the ``times`` budget is spent)."""
        return cls(
            specs=(
                FaultSpec(
                    site="h2d", kind="transient", rate=rate, times=times,
                    match=match,
                ),
            ),
            seed=seed,
        )

    @classmethod
    def h2d_stall(
        cls, stall_s: float, *, rate: float = 0.0, times: int | None = 1,
        seed: int = 0,
    ) -> "FaultPlan":
        """Slow-device injection: matching transfers sleep ``stall_s``."""
        return cls(
            specs=(
                FaultSpec(
                    site="h2d", kind="stall", stall_s=stall_s, rate=rate,
                    times=times,
                ),
            ),
            seed=seed,
        )

    @classmethod
    def storage_corrupt(
        cls, segment: str = "", *, times: int | None = None, seed: int = 0,
    ) -> "FaultPlan":
        """Segment reads matching ``segment`` observe corrupted bytes for
        the first ``times`` attempts (``None`` = persistent corruption)."""
        return cls(
            specs=(
                FaultSpec(site="storage", kind="corrupt", match=segment, times=times),
            ),
            seed=seed,
        )

    @classmethod
    def storage_short(
        cls, segment: str = "", *, times: int | None = None, seed: int = 0,
    ) -> "FaultPlan":
        """Segment reads matching ``segment`` come up short (truncated)."""
        return cls(
            specs=(
                FaultSpec(site="storage", kind="short", match=segment, times=times),
            ),
            seed=seed,
        )

    def merge(self, other: "FaultPlan") -> "FaultPlan":
        """Union of two plans (keeps this plan's seed)."""
        return FaultPlan(specs=self.specs + other.specs, seed=self.seed)

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)


class FaultInjector:
    """The live, counting instance of a :class:`FaultPlan`.

    One injector is shared by every layer of a session (engine loop,
    block fetcher, packed stream, backing store) so per-spec fire budgets
    are spent once, globally — a ``times=1`` crash that fired during the
    first attempt stays quiet during the resumed run.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._fired = [0] * len(plan.specs)  # per-spec fire count
        self._occ = [0] * len(plan.specs)  # per-spec occurrence counter
        self.injected = 0  # total raises/stalls/corruptions delivered

    # -- accounting ----------------------------------------------------------
    def fired(self, site: str | None = None) -> int:
        """Total injections delivered (optionally for one site)."""
        if site is None:
            return self.injected
        return sum(
            n
            for n, spec in zip(self._fired, self.plan.specs)
            if spec.site == site
        )

    def _coin(self, spec_index: int, occurrence: int) -> float:
        key = f"{self.plan.seed}:{spec_index}:{occurrence}".encode()
        return zlib.crc32(key) / 0xFFFFFFFF

    def _hits(self, site: str, identity) -> "list[FaultSpec]":
        hits = []
        for i, spec in enumerate(self.plan.specs):
            if spec.site != site:
                continue
            if spec.times is not None and self._fired[i] >= spec.times:
                continue
            if spec.match and spec.match not in str(identity):
                continue
            if spec.at:
                hit = isinstance(identity, int) and identity in spec.at
            elif spec.rate > 0.0:
                occ = self._occ[i]
                self._occ[i] += 1
                hit = self._coin(i, occ) < spec.rate
            else:
                hit = True  # unconditional (until the budget is spent)
            if hit:
                self._fired[i] += 1
                self.injected += 1
                hits.append(spec)
        return hits

    # -- the injection points ------------------------------------------------
    def check(self, site: str, identity) -> None:
        """Consult the plan at one event; raise / stall on a hit.

        ``identity`` is the event's stable label: the sweep/step number
        (int) or the transfer label (str). Stalls execute before any
        raise, so a stall+crash plan stalls then dies, like hardware.
        """
        hits = self._hits(site, identity)
        for spec in hits:
            if spec.kind == "stall":
                time.sleep(spec.stall_s)
        for spec in hits:
            if spec.kind == "transient":
                raise TransientFault(
                    f"injected transient fault at {site} {identity!r}"
                )
            if spec.kind == "crash":
                raise InjectedCrash(f"injected crash at {site} {identity!r}")

    def storage_read(self, segment: str, attempt: int) -> str | None:
        """Decision for one storage verification read of ``segment``.

        Returns ``"corrupt"`` / ``"short"`` when the read should observe
        bad bytes, ``None`` for a clean read. Storage specs are
        *attempt-indexed*: a ``times=k`` torn read clears on the k-th
        re-read (bounded retry heals it); ``times=None`` is persistent
        media corruption (retry cannot heal — quarantine).
        """
        for spec in self.plan.specs:
            if spec.site != "storage":
                continue
            if spec.match and spec.match not in segment:
                continue
            if spec.times is None or attempt < spec.times:
                self.injected += 1
                return spec.kind
        return None


def with_transient_retries(
    injector: FaultInjector | None,
    identity: str,
    fn,
    *,
    retries: int = 3,
    backoff_s: float = 0.001,
):
    """Run one transfer with bounded retry-with-backoff on injected faults.

    The self-healing wrapper at the H2D boundary: a transient fault is
    retried up to ``retries`` times with exponential backoff before it
    escapes to the caller (where serving-level retry / the circuit breaker
    take over). With no injector attached this is exactly ``fn()``.
    """
    if injector is None:
        return fn()
    attempt = 0
    while True:
        try:
            injector.check("h2d", identity)
            return fn()
        except TransientFault:
            if attempt >= retries:
                raise
            _OBS_RETRIES_H2D.inc()
            time.sleep(backoff_s * (2.0**attempt))
            attempt += 1


# ---------------------------------------------------------------------------
# Legacy train-loop primitives (runtime.fault re-exports them).
# FailureInjector keeps its exact API; its SimulatedFailure is the base
# class above, so the train loop's recovery path also catches engine-level
# InjectedCrash faults.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FailureInjector:
    """Raise SimulatedFailure at the given steps (each fires once)."""

    fail_at_steps: tuple[int, ...] = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time outlier detector.

    ``update`` returns True when the step took more than ``threshold`` ×
    the smoothed time — the signal a production controller uses to start
    the mitigation runbook (snapshot, evict host, re-mesh). The serving
    layer reuses it as the slow-sweep detector: every dispatched batch's
    run time feeds one watchdog and flagged batches count into
    ``ServerStats.slow_batches`` (injected H2D stalls show up here).
    """

    alpha: float = 0.1
    threshold: float = 3.0
    warmup: int = 5
    _ewma: float = 0.0
    _count: int = 0
    flagged: list = dataclasses.field(default_factory=list)

    def update(self, step: int, step_seconds: float) -> bool:
        self._count += 1
        if self._count <= self.warmup:
            # establish a baseline before flagging
            self._ewma = (
                step_seconds
                if self._ewma == 0.0
                else (1 - self.alpha) * self._ewma + self.alpha * step_seconds
            )
            return False
        is_straggler = step_seconds > self.threshold * self._ewma
        if is_straggler:
            self.flagged.append((step, step_seconds, self._ewma))
        else:
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * step_seconds
        return is_straggler


def elastic_device_count(
    available: int, *, model_parallel: int = 1, minimum: int = 1
) -> int:
    """Largest device count ≤ available that keeps the mesh valid.

    The model axis is fixed (parameter shardings must divide it); the data
    axis absorbs the loss — so usable = model_parallel × floor(available /
    model_parallel). Checkpoint reshard-on-load does the rest.
    """
    usable = (available // model_parallel) * model_parallel
    if usable < minimum:
        raise RuntimeError(
            f"only {available} devices available; need >= {minimum}"
        )
    return usable


class StepTimer:
    def __init__(self):
        self._t = None

    def tick(self) -> float:
        now = time.perf_counter()
        dt = 0.0 if self._t is None else now - self._t
        self._t = now
        return dt
