"""Share of the decoded rows (C x k a step, counter `decode.rows`) that
delivered a frame (`decode.delivered`)."""

from benchmark.harness.program_spans import counter_pct


def read(res):
    return counter_pct("decode.delivered", "decode.rows")
