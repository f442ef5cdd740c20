"""Device milliseconds a fold step in the program's `rx.step` span less
the `demod`, `ring_acq` and `decode` kernels of `layers.json` a block: the
torch kernels between the port's own."""

from benchmark.harness.program_spans import glue_ms


def read(res):
    return glue_ms(res)
