"""Host milliseconds per traced block in the program's ``upsert`` span: the
public data tree's K-sized planner step that classifies each write, finds
its leader and scatters each slot's last value (None where no such span
closed: a nullifier tree, or a program without the span)."""

from imtbench import program_trace

SPANS = ("upsert",)


def read(view):
    return program_trace.host_ms_per_unit(view, SPANS)
