"""Share of the traced window in which the card idled while the host's
innermost program span was `fold.assemble` (the fold blocks' assembly)."""

from benchmark.harness.program_spans import idle_pct_under


def read(res):
    return idle_pct_under(res, ("fold.assemble",))
