"""Mean lanes (hashes or permutations) per Poseidon launch over the traced
blocks, as the program's dispatch counts them."""

from imtbench import program_trace


def read(view):
    n = program_trace.counts(view, program_trace.LAUNCHES)
    lanes = program_trace.counts(view, program_trace.LANES)
    return lanes / n if n else None
