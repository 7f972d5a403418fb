"""Rebuild quarantined ``.dsss`` segments from the raw edge source (port of
``repro.reliability.repair``).

The last resort of the self-healing read path: when a segment stays
corrupt through the bounded re-read budget (persistent media damage, not
a torn read), the container itself is the casualty — but the raw edge
source that built it usually still exists. :func:`repair_dsss` scans the
damaged container, rebuilds a pristine replacement next to it with the
bounded external-memory build pipeline, verifies the replacement, and
atomically swaps it in (``os.replace``) — quarantine cleared, same path.

This is a whole-container rebuild, not a surgical segment splice: the
block and packed segments are derived views of one edge stream, so a
damaged ``p_src`` means re-deriving the tile layout anyway, and atomic
whole-file replacement is the only repair that can never leave a
half-patched container behind.

Kept out of ``repro_torch.reliability``'s eager imports — it pulls in the
storage build pipeline (and through it the core engine); import it as
``from repro_torch.reliability.repair import repair_dsss``.
"""
from __future__ import annotations

import os

__all__ = ["repair_dsss"]


def repair_dsss(
    path: str,
    source: str | None = None,
    *,
    weights: bool | None = None,
    P: int | None = None,
    **build_kwargs,
) -> dict:
    """Verify a container; rebuild it from ``source`` if any segment is bad.

    Args:
      path: the ``.dsss`` container to check/repair.
      source: text edge list the container was built from. ``None`` means
        report-only — damaged segments are listed but nothing is rebuilt.
      weights / P: rebuild parameters; default to the damaged container's
        own footer metadata (its footer survives segment corruption —
        both are crc-checked independently).
      build_kwargs: forwarded to
        :func:`repro_torch.storage.build.build_from_text` (``chunk_budget``,
        ``drop_self_loops``, ...).

    Returns a report dict: ``{"path", "damaged": [segment names],
    "repaired": bool, "source"}``. Raises :class:`ValueError` when damage
    is found but no source was given, and propagates build/verify errors
    from a failed rebuild (the damaged original is left untouched — the
    swap only happens after the replacement verifies clean).
    """
    from repro_torch.storage.build import build_from_text
    from repro_torch.storage.format import DSSSStore, verify_dsss

    store = DSSSStore(path)
    damaged = store.scan()
    report = {
        "path": path,
        "damaged": damaged,
        "repaired": False,
        "source": source,
    }
    if not damaged:
        return report
    if source is None:
        raise ValueError(
            f"{path}: segments {damaged} are damaged and no --source edge "
            "list was given to rebuild from"
        )
    if P is None:
        P = int(store.meta["P"])
    if weights is None:
        weights = bool(store.meta.get("weighted", False))
    tmp = path + ".repair.tmp"
    try:
        build_from_text(source, tmp, P, weights=weights, **build_kwargs)
        verify_dsss(tmp)  # never swap in an unverified replacement
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    report["repaired"] = True
    return report
