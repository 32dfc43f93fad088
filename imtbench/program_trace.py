"""The program's own spans and counters, as the per-layer readers see them.

The port keeps them in ``imt_tpu_torch.utils.observability``: on while a
``torch.profiler`` session runs, a session a profiled stretch, so the
newest session after a traced run holds the traced units and nothing else.
The readers look the module up among those the run has loaded (they import
nothing of the program) and find nothing where the program has no tracer,
where the run had no card, or where the session holds nothing.
"""

from __future__ import annotations

import sys

TRACER = "imt_tpu_torch.utils.observability"
LAUNCHES = ("hash2.launches", "hash3.launches", "perm.launches")
LANES = ("hash2.lanes", "hash3.lanes", "perm.lanes")


def session(view):
    """The tracer's newest session, profiled and not empty, as plain data
    (``{"spans": [...], "counts": {...}, ...}``), or None."""
    snapshot = getattr(sys.modules.get(TRACER), "snapshot", None)
    if not view.card or not view.units or snapshot is None:
        return None
    s = snapshot().get("session")
    if not s or not s.get("profiled") or not (s["spans"] or s["counts"]):
        return None
    return s


def host_ms_per_unit(view, names):
    """Host milliseconds per traced unit inside spans of `names`, each
    stretch counted once (a span nested in another of `names` is not
    added again), or None where no such span closed."""
    s = session(view)
    if s is None:
        return None
    spans, total, found = s["spans"], 0, False
    for sp in spans:
        if sp["name"] not in names or sp["end_ns"] is None:
            continue
        p = sp["parent"]
        while p is not None and spans[p]["name"] not in names:
            p = spans[p]["parent"]
        if p is None:
            total += sp["end_ns"] - sp["start_ns"]
            found = True
    return 1e-6 * total / view.units if found else None


def counts(view, names):
    """The session's sum of the counters `names`, or None."""
    s = session(view)
    if s is None:
        return None
    return sum(s["counts"].get(n, 0) for n in names)
