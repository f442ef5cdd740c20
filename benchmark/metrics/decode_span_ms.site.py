"""Device milliseconds a step in the program's `rx.decode` spans, over
all k extractions: the decode's kernels and its torch glue."""

from benchmark.harness.program_spans import device_ms_a_step


def read(res):
    return device_ms_a_step(("rx.decode",))
