"""Process-wide metrics registry — counters, gauges, histograms with labels.

Port of ``repro.obs.registry``: the same metric names, render and parse.

Zero-dependency (stdlib only) by design: the engine and the storage tier
publish into one process-global
:data:`REGISTRY`, and anything that can speak HTTP can scrape it as
Prometheus text exposition (:meth:`MetricsRegistry.render`, served by
:class:`repro_torch.obs.http.TelemetryServer`).

The publishing contract mirrors the engine's meter discipline: *metrics
are emitted where the data moves*. ``_BlockFetcher._upload`` increments
``repro_engine_bytes_total{kind="h2d"}`` on the same line that charges
``Meters.bytes_h2d``, so the registry's deltas across a run recombine
field-for-field with ``Result.meters`` (tests/test_torch_engine_obs.py
asserts this over the device/host/disk matrix).

Overhead: every mutating call checks ``registry.enabled`` first and
returns immediately when the registry is disabled (``REPRO_OBS=0`` in the
environment, or :meth:`MetricsRegistry.set_enabled`), so hot paths pay
one attribute load + branch. Enabled counters take one small lock per
increment — the finest-grained call sites are per-streamed-chunk and
per-sweep, far off the per-edge fast path.
"""
from __future__ import annotations

import math
import os
import threading

__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramValue",
    "MetricsRegistry",
    "REGISTRY",
    "parse_prometheus",
]

# Fixed latency buckets (seconds) of a histogram by default — 0.5 ms ..
# 10 s, roughly log-spaced.
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 2**53 else repr(f)


class _Value:
    """One labeled time series of a counter/gauge family."""

    __slots__ = ("_family", "_lock", "value")

    def __init__(self, family):
        self._family = family
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not self._family._registry.enabled:
            return
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        if not self._family._registry.enabled:
            return
        with self._lock:
            self.value = float(value)

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class HistogramValue:
    """A fixed-bucket histogram series; usable standalone or in a family.

    ``observe`` files the sample into the first bucket whose upper bound
    covers it; ``quantile(q)`` linearly interpolates within the covering
    bucket (the standard fixed-bucket estimator — exact at bucket edges,
    bounded error inside). Standalone instances (``family=None``) have no
    registry gate and always record, so a server can own one whose
    percentile stats no other server in the process pollutes.
    """

    __slots__ = ("_family", "_lock", "bounds", "counts", "sum", "count")

    def __init__(self, buckets=DEFAULT_LATENCY_BUCKETS, family=None):
        self._family = family
        self._lock = threading.Lock()
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if self._family is not None and not self._family._registry.enabled:
            return
        i = 0
        for i, b in enumerate(self.bounds):  # noqa: B007
            if value <= b:
                break
        else:
            i = len(self.bounds)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1); 0.0 with no observations."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.bounds[-1]


class _Family:
    """A named metric with a label schema; children keyed by label values."""

    kind = "untyped"

    def __init__(self, registry, name: str, help: str, labelnames=()):
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}

    def _make_child(self):
        return _Value(self)

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise TypeError("pass label values positionally or by name")
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values!r}"
            )
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._make_child())
        return child

    # Label-less convenience: family proxies its single child.
    def inc(self, amount: float = 1.0):
        self.labels().inc(amount)

    def set(self, value: float):
        self.labels().set(value)

    def dec(self, amount: float = 1.0):
        self.labels().dec(amount)

    def observe(self, value: float):
        self.labels().observe(value)

    def samples(self):
        """Yield ``(labelvalues, child)`` pairs (stable label order)."""
        with self._lock:
            items = sorted(self._children.items())
        return items


class Counter(_Family):
    kind = "counter"


class Gauge(_Family):
    kind = "gauge"


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, registry, name, help, labelnames=(), buckets=None):
        super().__init__(registry, name, help, labelnames)
        self.buckets = tuple(buckets or DEFAULT_LATENCY_BUCKETS)

    def _make_child(self):
        return HistogramValue(self.buckets, family=self)


class MetricsRegistry:
    """Name → metric family; idempotent registration; Prometheus render.

    Registering an existing name returns the existing family (so modules
    can declare their handles at import time without coordination) —
    re-registering with a different type or label schema raises.
    """

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("REPRO_OBS", "1") != "0"
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = bool(enabled)

    def _register(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.labelnames}"
                    )
                return fam
            fam = cls(self, name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames=(), buckets=None
    ) -> Histogram:
        return self._register(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> _Family | None:
        return self._families.get(name)

    def value(self, name: str, **labels) -> float:
        """Current value of one series (0.0 if the series doesn't exist).

        The test/CI-facing read API: snapshot before, snapshot after, the
        delta is what the intervening code published.
        """
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        values = tuple(str(labels[n]) for n in fam.labelnames)
        child = fam._children.get(values)
        if child is None:
            return 0.0
        if isinstance(child, HistogramValue):
            return float(child.count)
        return float(child.value)

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4) of every family."""
        out = []
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            if fam.help:
                out.append(f"# HELP {name} {fam.help}")
            out.append(f"# TYPE {name} {fam.kind}")
            for values, child in fam.samples():
                pairs = [
                    f'{n}="{_escape_label(v)}"'
                    for n, v in zip(fam.labelnames, values)
                ]
                if isinstance(child, HistogramValue):
                    cum = 0
                    for bound, c in zip(
                        (*child.bounds, math.inf),
                        child.counts,
                    ):
                        cum += c
                        lab = ", ".join(
                            (*pairs, f'le="{_fmt_value(bound)}"')
                        ) if pairs else f'le="{_fmt_value(bound)}"'
                        out.append(f"{name}_bucket{{{lab}}} {cum}")
                    suffix = "{" + ", ".join(pairs) + "}" if pairs else ""
                    out.append(f"{name}_sum{suffix} {_fmt_value(child.sum)}")
                    out.append(f"{name}_count{suffix} {child.count}")
                else:
                    suffix = "{" + ", ".join(pairs) + "}" if pairs else ""
                    out.append(f"{name}{suffix} {_fmt_value(child.value)}")
        return "\n".join(out) + "\n"


def parse_prometheus(text: str) -> dict[tuple, float]:
    """Parse text exposition back into ``{(name, (('l','v'),...)): value}``.

    The scrape-side inverse of :meth:`MetricsRegistry.render`, used by the
    CI consistency gate (scraped counters == ``ServerStats`` fields) and
    by tests. Handles only the subset ``render`` emits — one metric per
    line, quoted label values, no exemplars.
    """
    out: dict[tuple, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            rest = rest.rstrip("}")
            labels = []
            for item in _split_labels(rest):
                ln, _, lv = item.partition("=")
                labels.append((ln.strip(), lv.strip().strip('"')))
            key = (name, tuple(sorted(labels)))
        else:
            key = (name_part, ())
        value_part = value_part.strip()
        value = math.inf if value_part == "+Inf" else float(value_part)
        out[key] = value
    return out


def _split_labels(s: str) -> list[str]:
    items, depth, cur = [], False, []
    for ch in s:
        if ch == '"':
            depth = not depth
        if ch == "," and not depth:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        items.append("".join(cur))
    return [i.strip() for i in items if i.strip()]


#: The process-global default registry every repro subsystem publishes to.
REGISTRY = MetricsRegistry()
