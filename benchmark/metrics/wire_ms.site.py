"""Device milliseconds a step in the program's `rx.ingest` and
`rx.demod.layout` spans: the int8 wire to K1's `(T, C)` input planes."""

from benchmark.harness.program_spans import device_ms_a_step


def read(res):
    return device_ms_a_step(("rx.ingest", "rx.demod.layout"))
