"""Host milliseconds per traced block in the program's ``spine`` spans:
the zero-spine fold of a sparse tree's root above its active prefix, one
hash2 launch a level enqueued (the root's read-back is the ``wait`` span
of ``get_root``, outside it); None where no such span closed."""

from imtbench import program_trace

SPANS = ("spine",)


def read(view):
    return program_trace.host_ms_per_unit(view, SPANS)
