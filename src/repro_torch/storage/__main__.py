"""CLI for the on-disk DSSS store (port of ``repro.storage``'s).

    python -m repro_torch.storage build edges.txt graph.dsss --P 16
    python -m repro_torch.storage info graph.dsss
    python -m repro_torch.storage verify graph.dsss
    python -m repro_torch.storage verify graph.dsss --repair --source edges.txt

``build`` streams a SNAP-style text edge list (``src dst [weight]`` per
line, ``#`` comments) through the bounded-RAM external-memory pipeline;
``info`` prints the header and segment directory; ``verify`` recomputes
every segment checksum and exits non-zero on mismatch or truncation.
``verify --repair`` instead scans all segments, reports every damaged
one, and — given ``--source`` — rebuilds the container from the raw edge
list and atomically swaps the verified replacement in
(:func:`repro_torch.reliability.repair.repair_dsss`).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.storage.build import build_from_text
from repro_torch.storage.format import FormatError, store_info, verify_dsss


def _cmd_build(args) -> int:
    stats = build_from_text(
        args.input,
        args.output,
        args.P,
        weights=args.weights,
        comment=args.comment,
        chunk_budget=args.chunk_budget,
        drop_self_loops=args.drop_self_loops,
        dedup=not args.keep_duplicates,
        packing=None if args.no_packed else "adaptive",
    )
    print(
        f"built {stats.path}: n={stats.n} m={stats.m} (raw {stats.m_raw}) "
        f"P={stats.P} blocks={stats.num_blocks} tiles={stats.num_tiles}"
        f"x{stats.tile_edges}"
    )
    print(
        f"bounded build: peak resident edge bytes {stats.peak_edge_bytes} "
        f"(budget {stats.chunk_budget}, {stats.num_chunks} chunks, "
        f"{stats.streamed_buckets} k-way-merged buckets, "
        f"spill {stats.spill_bytes} bytes)"
    )
    return 0


def _cmd_info(args) -> int:
    try:
        info = store_info(args.path)
    except (FormatError, OSError) as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    meta = info["meta"]
    print(f"{args.path}: .dsss v{meta['version']}")
    print(
        f"  n={meta['n']} m={meta['m']} P={meta['P']} "
        f"interval_size={meta['interval_size']} "
        f"weighted={meta['weighted']} src_sorted={meta['src_sorted']} "
        f"blocks={meta.get('num_blocks')}"
    )
    if meta.get("packing"):
        print(
            f"  packed: {meta['packing']} tiles={meta.get('num_tiles')} "
            f"x{meta.get('tile_edges')} edges"
        )
    print(
        f"  file {info['file_bytes']} bytes, "
        f"{len(info['segments'])} segments ({info['segment_bytes']} bytes)"
    )
    for seg in info["segments"]:
        shape = "x".join(str(s) for s in seg["shape"])
        print(f"    {seg['name']:<16} {seg['dtype']:<8} ({shape})  {seg['nbytes']}B")
    return 0


def _cmd_verify(args) -> int:
    if args.repair:
        return _cmd_repair(args)
    try:
        store = verify_dsss(args.path)
    except (FormatError, OSError) as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(
        f"OK: {args.path} ({len(store.segments)} segments, "
        f"n={store.meta['n']} m={store.meta['m']})"
    )
    return 0


def _cmd_repair(args) -> int:
    from repro_torch.reliability.repair import repair_dsss

    try:
        report = repair_dsss(
            args.path,
            args.source,
            chunk_budget=args.chunk_budget,
        )
    except (FormatError, OSError, ValueError) as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    if not report["damaged"]:
        print(f"OK: {args.path} (all segments clean, nothing to repair)")
        return 0
    print(
        f"repaired {args.path}: damaged segments "
        f"{', '.join(report['damaged'])} rebuilt from {report['source']}"
    )
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.storage")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="text edge list -> .dsss (bounded RAM)")
    b.add_argument("input")
    b.add_argument("output")
    b.add_argument("--P", type=int, default=16, help="number of intervals")
    b.add_argument("--weights", action="store_true", help="read a third column")
    b.add_argument("--comment", default="#")
    b.add_argument(
        "--chunk-budget", type=int, default=64 << 20,
        help="target resident edge-array bytes during the build",
    )
    b.add_argument("--drop-self-loops", action="store_true")
    b.add_argument("--keep-duplicates", action="store_true")
    b.add_argument(
        "--no-packed", action="store_true",
        help="skip the PackedSweep tile section",
    )
    b.set_defaults(fn=_cmd_build)

    i = sub.add_parser("info", help="print header + segment directory")
    i.add_argument("path")
    i.set_defaults(fn=_cmd_info)

    v = sub.add_parser("verify", help="recompute all segment checksums")
    v.add_argument("path")
    v.add_argument(
        "--repair", action="store_true",
        help="scan all segments and rebuild the container from --source "
        "if any are damaged (atomic swap after the rebuild verifies)",
    )
    v.add_argument(
        "--source", default=None,
        help="raw text edge list to rebuild damaged containers from",
    )
    v.add_argument(
        "--chunk-budget", type=int, default=64 << 20,
        help="rebuild chunk budget (see `build`)",
    )
    v.set_defaults(fn=_cmd_verify)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
