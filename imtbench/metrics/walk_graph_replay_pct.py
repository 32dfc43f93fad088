"""Share of the traced blocks' witness walks replayed from a CUDA graph,
as the program counts them: 100 x ``walk.graph_replays`` / (that +
``walk.eager``, the walks run op by op); None where neither counter
moved."""

from imtbench import program_trace


def read(view):
    replays = program_trace.counts(view, ("walk.graph_replays",))
    walks = program_trace.counts(view, ("walk.graph_replays", "walk.eager"))
    return 100.0 * replays / walks if walks else None
