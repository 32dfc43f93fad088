"""Host milliseconds per traced block in the planner's program spans:
``sort`` (the final-list sort), ``link`` (the links and pointer rewrites),
``temporal`` (the witness batch's temporal planning) and ``leaf_hash``
(the width-2K hash3 of the dirty leaves)."""

from imtbench import program_trace

SPANS = ("sort", "link", "temporal", "leaf_hash")


def read(view):
    return program_trace.host_ms_per_unit(view, SPANS)
