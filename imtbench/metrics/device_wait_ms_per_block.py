"""Host milliseconds per traced block in the program's ``wait`` spans,
where the host blocks on the device (the acceptance mask's and the root's
reads)."""

from imtbench import program_trace


def read(view):
    return program_trace.host_ms_per_unit(view, ("wait",))
