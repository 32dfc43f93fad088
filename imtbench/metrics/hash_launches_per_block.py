"""Poseidon launches per traced block, as the program's dispatch counts
them: hash2, hash3 and permutation launches."""

from imtbench import program_trace


def read(view):
    n = program_trace.counts(view, program_trace.LAUNCHES)
    return n / view.units if n else None
