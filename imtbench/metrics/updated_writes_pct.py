"""Share of the traced blocks' accepted writes that updated a slot already
in the tree, as the program counts the outcomes it hands to the host: 100
x ``writes.updated`` / (that + ``writes.inserted``); None where neither
counter moved."""

from imtbench import program_trace


def read(view):
    updated = program_trace.counts(view, ("writes.updated",))
    writes = program_trace.counts(view, ("writes.updated",
                                         "writes.inserted"))
    return 100.0 * updated / writes if writes else None
