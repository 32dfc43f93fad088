"""Host milliseconds per traced block in the witness walk's program spans:
``walk`` (the level-synchronous walk) and ``finish`` (the roots folded,
the proofs extended and decoded)."""

from imtbench import program_trace

SPANS = ("walk", "finish")


def read(view):
    return program_trace.host_ms_per_unit(view, SPANS)
