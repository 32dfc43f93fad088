"""Host milliseconds per traced block in the path update's program spans:
``paths`` (the dirty paths below the crossover) and ``rebuild`` (the
levels above it, once a chain of blocks)."""

from imtbench import program_trace

SPANS = ("paths", "rebuild")


def read(view):
    return program_trace.host_ms_per_unit(view, SPANS)
