"""Zero-spine hash launches per traced block, as the program counts them:
``spine.launches``, one hash2 launch a level folded above a sparse tree's
active prefix (each also counted under ``hash2.launches``).  A block of
the sync cells reads its root once, so at depth F and prefix 2^ad this is
F - ad; None where the counter did not move (a dense tree, or a program
without the counter)."""

from imtbench import program_trace


def read(view):
    n = program_trace.counts(view, ("spine.launches",))
    return n / view.units if n else None
