"""Share of the RS codewords (counter `rs.codewords`) that K8 found
errored, corrected or not (`rs.errored`)."""

from benchmark.harness.program_spans import counter_pct


def read(res):
    return counter_pct("rs.errored", "rs.codewords")
