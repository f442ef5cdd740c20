"""Device milliseconds a block from the step's last queued kernel to its
results in pinned host memory (CUDA events of the traced run)."""

import numpy as np


def read(res):
    d = res["counters"].get("deliver_ms")
    return float(np.mean(d)) if d else None
