"""Share of the traced window in which the card idled while the host's
innermost program span was `fold.pull` or `fold.dedup` (the results' copy
to the host and the deduplication)."""

from benchmark.harness.program_spans import idle_pct_under


def read(res):
    return idle_pct_under(res, ("fold.pull", "fold.dedup"))
