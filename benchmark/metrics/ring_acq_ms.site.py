"""Device milliseconds a block in the `ring_acq` layer's kernels (`layers.json`)."""

from benchmark.harness.readers import layer_ms


def read(res):
    return layer_ms(res, "ring_acq")
