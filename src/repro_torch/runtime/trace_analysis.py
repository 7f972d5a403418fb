"""Offline analysis of exported engine traces — stdlib only.

Port of ``repro.runtime.trace_analysis``. Reads what
:class:`repro_torch.obs.Tracer` writes — Chrome ``trace_event``
JSON (``TraceSpec(path="run.json")`` / ``Tracer.export``) or the raw
one-span-per-line ``.jsonl`` dump — and folds the span stream back into
per-run facts: how long each update sweep took, how many bytes each
moved, which execution backend ran.

The join key is the ``run`` id the engine stamps into every span it
records for one ``_execute`` call — "sweep" spans carry the same
``args["run"]`` as their parent "run" span, so a trace holding many runs
decomposes exactly.
"""
from __future__ import annotations

import json

__all__ = ["load_events", "run_summaries", "fmt_run_table"]


def load_events(path: str) -> list[dict]:
    """Normalized spans from a trace file: ``ts``/``dur`` in seconds.

    Accepts Chrome ``trace_event`` JSON (timestamps in µs; ``M``-phase
    metadata events are dropped) or a raw ``.jsonl`` span dump
    (timestamps already in seconds).
    """
    with open(path) as fh:
        text = fh.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        spans = [json.loads(ln) for ln in text.splitlines() if ln.strip()]
        scale = 1.0
    else:
        if isinstance(doc, dict) and "traceEvents" in doc:
            spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
            scale = 1e-6
        elif isinstance(doc, list):
            spans = doc
            scale = 1.0
        else:
            spans = [doc]
            scale = 1.0
    return [
        {
            "name": s["name"],
            "cat": s.get("cat", "repro"),
            "ts": float(s.get("ts", 0.0)) * scale,
            "dur": float(s.get("dur", 0.0)) * scale,
            "args": dict(s.get("args", {})),
        }
        for s in spans
    ]


def run_summaries(events: list[dict]) -> list[dict]:
    """One summary per engine "run" span, with its sweeps folded in.

    Each summary carries the run's identity (program / strategy /
    residency / execution / graph shape), its total ``wall_s``, and the
    sweep-level aggregates: ``sweeps``/``sweep_wall_s``/``mean_sweep_s``
    plus the per-sweep physical byte sums (which, for a fresh run, equal
    the run's ``Result.meters`` fields — the exactness contract).
    """
    sweeps_by_run: dict = {}
    for e in events:
        if e["name"] == "sweep":
            sweeps_by_run.setdefault(e["args"].get("run"), []).append(e)
    out = []
    for e in events:
        if e["name"] != "run":
            continue
        a = e["args"]
        sw = sweeps_by_run.get(a.get("run"), [])
        sweep_wall = sum(s["dur"] for s in sw)
        out.append(
            {
                "run": a.get("run"),
                "program": a.get("program"),
                "strategy": a.get("strategy"),
                "residency": a.get("residency"),
                "execution": a.get("execution"),
                "K": a.get("K"),
                "n": a.get("n"),
                "m": a.get("m"),
                "P": a.get("P"),
                "converged": a.get("converged"),
                "wall_s": e["dur"],
                "sweeps": len(sw) or a.get("sweeps", 0),
                "sweep_wall_s": sweep_wall,
                "mean_sweep_s": sweep_wall / len(sw) if sw else 0.0,
                "bytes_h2d": sum(
                    s["args"].get("bytes_h2d", 0.0) for s in sw
                ),
                "bytes_disk_read": sum(
                    s["args"].get("bytes_disk_read", 0.0) for s in sw
                ),
            }
        )
    return out


def fmt_run_table(summaries: list[dict]) -> str:
    """Markdown table of per-run sweep facts (the ``--trace`` report)."""
    hdr = (
        "| run | program | backend | residency | sweeps | mean sweep (ms) "
        "| h2d MB | disk MB |"
    )
    lines = [hdr, "|" + "---|" * 8]
    for r in summaries:
        lines.append(
            f"| {r['run']} | {r['program']} | {r['execution']} | "
            f"{r['residency']} | {r['sweeps']} | "
            f"{r['mean_sweep_s'] * 1e3:.2f} | "
            f"{r['bytes_h2d'] / 1e6:.2f} | "
            f"{r['bytes_disk_read'] / 1e6:.2f} |"
        )
    return "\n".join(lines)
