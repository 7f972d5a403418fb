"""CLI: convert raw span dumps into Perfetto-loadable trace JSON.

``python -m repro_torch.obs export-trace spans.jsonl [-o trace.json]``

The input is a one-span-per-line ``.jsonl`` dump (what
``Tracer.dump`` / ``TraceSpec(path="....jsonl")`` write); the output is
Chrome ``trace_event`` JSON, loadable at https://ui.perfetto.dev or
``chrome://tracing``. A Chrome-format input passes through unchanged
(handy for re-stamping an already-exported trace). With no ``-o`` the
output lands next to the input with a ``.json`` suffix.
"""
from __future__ import annotations

import argparse
import json
import sys


def _load_raw(path: str) -> list[dict]:
    with open(path) as fh:
        text = fh.read()
    try:  # whole-file JSON ⇒ already a Chrome trace object
        doc = json.loads(text)
    except json.JSONDecodeError:
        spans = [json.loads(line) for line in text.splitlines() if line.strip()]
    else:
        if isinstance(doc, dict) and "traceEvents" in doc:
            return doc["traceEvents"]
        spans = doc if isinstance(doc, list) else [doc]  # 1-line jsonl
    events: list[dict] = []
    seen_tids: dict[int, str] = {}
    for s in spans:
        tid = int(s.get("tid", 1))
        seen_tids.setdefault(tid, str(s.get("tlabel", tid)))
    for tid, label in sorted(seen_tids.items()):
        events.append(
            {
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "name": "thread_name",
                "args": {"name": label},
            }
        )
    for s in spans:
        if "ph" in s:  # already an event, pass through
            events.append(s)
            continue
        events.append(
            {
                "name": s["name"],
                "cat": s.get("cat", "repro"),
                "ph": "X",
                "pid": 1,
                "tid": int(s.get("tid", 1)),
                "ts": float(s["ts"]) * 1e6,
                "dur": float(s.get("dur", 0.0)) * 1e6,
                "args": s.get("args", {}),
            }
        )
    return events


def export_trace(src: str, out: str | None = None) -> str:
    events = _load_raw(src)
    if out is None:
        out = (src[: -len(".jsonl")] if src.endswith(".jsonl") else src) + ".json"
    with open(out, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
    spans = [e for e in events if e.get("ph") == "X"]
    names = sorted({e["name"] for e in spans})
    print(
        f"wrote {out}: {len(spans)} spans "
        f"({', '.join(names[:8])}{'...' if len(names) > 8 else ''})"
    )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description=__doc__
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    exp = sub.add_parser(
        "export-trace",
        help="convert a raw span dump (.jsonl) to Perfetto trace JSON",
    )
    exp.add_argument("src", help="span dump (.jsonl) or Chrome trace (.json)")
    exp.add_argument("-o", "--out", default=None, help="output path")
    args = ap.parse_args(argv)
    if args.cmd == "export-trace":
        export_trace(args.src, args.out)
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
