"""Device milliseconds a block in the `demod` layer's kernels (`layers.json`)."""

from benchmark.harness.readers import layer_ms


def read(res):
    return layer_ms(res, "demod")
